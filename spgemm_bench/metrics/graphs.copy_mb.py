"""graphs.copy_mb: the MiB a call's CUDA graph replays copy, by the
program's counter ``graphs.copy_bytes`` (``ops/graphs.Graph.replay``:
the arguments copied into the static inputs plus the outputs cloned
out)."""
from spgemm_bench import recorded


def read(ctx):
    return recorded.per_call(recorded.counter("graphs.copy_bytes"), ctx,
                             2.0 ** -20)
