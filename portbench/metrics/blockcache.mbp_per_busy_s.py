"""blockcache.mbp_per_busy_s: the bases a sweep's later phrases read back
from the block cache (counter `blockcache.bases_replayed`) over the reader
threads' seconds reading them (`blockcache.replay_s`), in Mbp/s, from the
run logs' `counters:` lines (portbench/spans.py).  Nothing where no job
replays the cache.  Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    return spans.ratio(ctx, ("counters", "blockcache.bases_replayed"),
                       ("counters", "blockcache.replay_s"), scale=1e-6)
