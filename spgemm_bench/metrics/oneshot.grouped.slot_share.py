"""oneshot.grouped.slot_share: the products a call computes
(``Driver.work``: nnzCt, half its operations) as a share of the product
slots grouped ESC expands, sorts and run-sums for it, by the program's
counter ``grouped.slots`` (``ops/grouped.spgemm_grouped``: its plan's
``prod_cap``, every call). The rest are padding: B's rows rounded up to
the plan's lanes, and every group's slots to the fullest group's.
Nothing where the counter reads 0 or nothing: a program without it, a
window whose calls took another path, or a run untraced."""
from spgemm_bench import recorded


def read(ctx):
    slots = recorded.per_call(recorded.counter("grouped.slots"), ctx)
    if not slots:
        return None
    return 100.0 * (ctx.work.flops / 2) / slots
