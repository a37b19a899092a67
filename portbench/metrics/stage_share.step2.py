"""stage_share.step2: the step2 stage's seconds in the run logs' `stages:`
lines (the program's StageTimers), over the jobs' walls, in %.  Moves
mbp_per_s."""


def read(ctx):
    walls = sum(j["wall_s"] for j in ctx.jobs)
    if not walls:
        return None
    return 100.0 * sum(j["stages"].get("step2", 0.0) for j in ctx.jobs) / walls
