"""numeric.device_ms: the device's busy time inside the calls of the
traced window (the union of the profiler's kernels and copies), over the
calls. Nothing when the trace holds no device activity."""


def read(ctx):
    p = ctx.profile
    if p is None or p.call_busy_s <= 0:
        return None
    return p.call_busy_s / ctx.calls * 1e3
