"""span_share.device_wait: the program's `step1.wait` and `step2.wait` spans
(the host waiting on a result from the card) over the jobs' walls, in %,
from the run logs' `spans:` lines (portbench/spans.py).  Both lie inside the
step1 and step2 stages.  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.span_share(ctx, ("step1.wait", "step2.wait"))
