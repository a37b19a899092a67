"""span_share.setup: the program's `setup` and `model` spans (argument and
parameter log, engine construction, the run's preamble; the table upload
and kernel library load) over the jobs' walls, in %, from the run logs'
`spans:` lines (portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.span_share(ctx, ("setup", "model"))
