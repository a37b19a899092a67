"""subset.reread_share: the subset writer's seconds re-reading the input
(inflate and parse, counter `subset.reread_s`, the C++ writer's steady
clock) over the `subset` span's seconds, in %, from the run logs'
`spans:` and `counters:` lines (portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.ratio(ctx, ("counters", "subset.reread_s"), ("spans", "subset"))
