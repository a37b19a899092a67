"""reader.inflate_share: the seconds the C++ reader spent in its gzip
inflate (counter `reader.inflate_s`) over the seconds the reader threads
spent producing blocks (`reader.busy_s`), in %, from the run logs'
`counters:` lines (portbench/spans.py).  Nothing where no job counts the
inflate (a program that predates the counter).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    got = spans.jobs(ctx)
    if got is None or not any("reader.inflate_s" in c for _, _, c in got):
        return None
    return spans.ratio(ctx, ("counters", "reader.inflate_s"), ("counters", "reader.busy_s"))
