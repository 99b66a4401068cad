"""chunked.out_slots_m: the millions of slots a chunked call sizes and
compacts C at, by the program's counter ``chunked.out_slots``
(``ops/chunked.spgemm_chunked``: its plan's ``out_cap``, every call); the
floor is nnz(C). Nothing where the counter reads 0 or nothing: a program
without it, or a run untraced."""
from spgemm_bench import recorded


def read(ctx):
    slots = recorded.per_call(recorded.counter("chunked.out_slots"), ctx)
    if not slots:
        return None
    return slots / 1e6
