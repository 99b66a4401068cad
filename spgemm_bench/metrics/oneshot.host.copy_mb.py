"""oneshot.host.copy_mb: the MiB a one-shot call copies from the device
to the host for its plans, by the program's counter ``host.d2h_bytes``
(``sparse/csr.host_view``'s copies; a buffer already copied is not
copied again)."""
from spgemm_bench import recorded


def read(ctx):
    return recorded.per_call(recorded.counter("host.d2h_bytes"), ctx,
                             2.0 ** -20)
