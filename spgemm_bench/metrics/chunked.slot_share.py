"""chunked.slot_share: the products a call computes (``Driver.work``:
nnzCt, half its operations) as a share of the product-stream slots the
chunked path expands, sorts and run-sums for it, by the program's counter
``chunked.slots`` (``ops/chunked.spgemm_chunked``: its plan's
``prod_cap``, every call). Nothing where the counter reads 0 or nothing:
a program without it, or a run untraced."""
from spgemm_bench import recorded


def read(ctx):
    slots = recorded.per_call(recorded.counter("chunked.slots"), ctx)
    if not slots:
        return None
    return 100.0 * (ctx.work.flops / 2) / slots
