"""numeric_roofline: the least time of one call's product (``Driver.work``:
read-once CSR bytes of the operands and the result, 2·nnzCt operations, at
the H100 SXM's data-sheet peaks, ``roofline.py``) as a share of the
device's busy time a call (``numeric.device_ms``). The same work whatever
implements it; nothing when the trace holds no device activity."""


def read(ctx):
    p = ctx.profile
    if p is None or p.call_busy_s <= 0:
        return None
    return 100.0 * ctx.work.least_s() / (p.call_busy_s / ctx.calls)
