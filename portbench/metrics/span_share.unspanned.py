"""span_share.unspanned: 1 - the program's phases (setup, model,
reader_wait, step1, step2, rows, subset, emit, aggregate: disjoint) over the
jobs' walls, in %: what no span of the program names, from the run logs'
`spans:` lines (portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    share = spans.span_share(ctx, spans.PHASES)
    return None if share is None else 100.0 - share
