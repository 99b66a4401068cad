"""oneshot.dispatch.host_ms: the mean host time a one-shot call spends
in the dispatcher's pick, by the program's span ``dispatch.choose``
(``ops/dispatch.choose_method``: the structure's stats and the seven
estimates, the plan the tilepack estimate builds included)."""
from spgemm_bench import recorded


def read(ctx):
    return recorded.per_call(recorded.span_seconds("dispatch.choose"), ctx,
                             1e3)
