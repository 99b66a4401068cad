"""oneshot.plan.host_ms: the mean host time a one-shot call spends
building the picked method's host plan after the pick, by the program's
span ``api.plan`` (in ``api.resolve_method``; apart from
``dispatch.choose``)."""
from spgemm_bench import recorded


def read(ctx):
    return recorded.per_call(recorded.span_seconds("api.plan"), ctx, 1e3)
