"""reader.mbp_per_busy_s: the input's bases (counter `bases.in`, every
record) over the seconds the reader threads spent producing blocks
(counter `reader.busy_s`), in Mbp/s, from the run logs' `counters:` lines
(portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.ratio(ctx, ("counters", "bases.in"), ("counters", "reader.busy_s"),
                       scale=1e-6)
