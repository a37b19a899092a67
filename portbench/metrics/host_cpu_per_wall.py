"""host_cpu_per_wall: the process's CPU seconds (every thread, user and
system) over the window's wall, in cores: a gain bought with more cores
shows here.  Moves mbp_per_s."""


def read(ctx):
    return ctx.cpu_s / ctx.window_s if ctx.window_s else None
