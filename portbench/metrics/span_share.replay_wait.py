"""span_share.replay_wait: the program's `replay_wait` span (the main thread
blocked on the reader thread's next block where a sweep's later phrase
replays the block cache) over the jobs' walls, in %, from the run logs'
`spans:` lines (portbench/spans.py).  Nothing where no job has the span
(one phrase, or a program that predates it).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    got = spans.jobs(ctx)
    if got is None or not any("replay_wait" in s for _, s, _ in got):
        return None
    return spans.span_share(ctx, ("replay_wait",))
