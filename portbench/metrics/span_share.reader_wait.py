"""span_share.reader_wait: the program's `reader_wait` span (the main thread
blocked on the reader thread's next block) over the jobs' walls, in %, from
the run logs' `spans:` lines (portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.span_share(ctx, ("reader_wait",))
