"""device.idle_share: the share of the traced window in which no kernel
or copy ran on the device (one minus the union of the profiler's device
intervals over the window). Nothing when the trace holds no device
activity."""


def read(ctx):
    p = ctx.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
