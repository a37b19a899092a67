"""step2.useful_share: the tail bases of passing reads (counter
`step2.bases_work`) over the bases step 2 launched, rows x scan length with
the padding (counter `step2.bases_launched`), in %, from the run logs'
`counters:` lines (portbench/spans.py).  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.ratio(ctx, ("counters", "step2.bases_work"),
                       ("counters", "step2.bases_launched"))
