"""blockcache.write_share: the seconds the reader threads spent pickling and
writing the block cache's records in a sweep's first phrase (counter
`blockcache.write_s`) over their seconds parsing (`reader.busy_s`), in %,
from the run logs' `counters:` lines (portbench/spans.py).  Nothing where no
job writes the cache (one phrase, or a program that predates the counter).
Moves mbp_per_s."""

from portbench import spans


def read(ctx):
    got = spans.jobs(ctx)
    if got is None or not any("blockcache.write_s" in c for _, _, c in got):
        return None
    return spans.ratio(ctx, ("counters", "blockcache.write_s"), ("counters", "reader.busy_s"))
