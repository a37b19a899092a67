"""span_share.output: the program's `rows`, `emit` and `aggregate` spans
(result rows, the CSV and manifest, the aggregate lines and quadratic-fit
plot) over the jobs' walls, in %, from the run logs' `spans:` lines
(portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.span_share(ctx, ("rows", "emit", "aggregate"))
