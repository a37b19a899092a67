"""stage_share.other: the share of the jobs' walls outside the program's
timed stages (step1, step2, subset): engine construction, parse waits, the
block cache, the CSV, the aggregates.  In %.  Moves mbp_per_s."""


def read(ctx):
    walls = sum(j["wall_s"] for j in ctx.jobs)
    if not walls:
        return None
    staged = sum(sum(j["stages"].values()) for j in ctx.jobs)
    return 100.0 * (1.0 - staged / walls)
