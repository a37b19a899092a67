"""device_idle_share: 1 - the union of kernel and copy intervals on the card
(torch.profiler) over the traced window's wall, in %.  Nothing without a
trace that holds device time.  Moves mbp_per_s."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.has_device_time():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
