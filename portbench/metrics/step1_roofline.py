"""step1_roofline: the least time the card needs for the step1 work of the
traced jobs (portbench/roofline.py, counted from the reference's results
on the cell's inputs) over the device time of the kernels that
portbench/kernels.json maps to step1 (torch.profiler), in %.  Nothing when
the trace holds no such kernel.  Moves mbp_per_s."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.step_s("step1")
    if device_s <= 0:
        return None
    return 100.0 * len(ctx.jobs) * ctx.roofline.bound_of_job(ctx.work, "step1") / device_s
