"""subset.kept_share: the files whose subset was written from the first parse
(counter `subset.kept_files`) over those and the files whose subset writer read
the input again (`subset.reread_files`), in %, from the run logs' `counters:`
lines (portbench/spans.py).  Nothing where no job counts either.  Moves
mbp_per_s."""

from portbench import spans


def read(ctx):
    got = spans.jobs(ctx)
    if got is None:
        return None
    kept = sum(c.get("subset.kept_files", 0.0) for _, _, c in got)
    reread = sum(c.get("subset.reread_files", 0.0) for _, _, c in got)
    return 100.0 * kept / (kept + reread) if kept + reread else None
