"""dispatch_plan.host_ms: the mean host time a call spends in the facade's
dispatch and host plan, ``api.resolve_method``, by the benchmark's own
span around it in the traced run. Nothing where no call resolves a
method."""


def read(ctx):
    spans = ctx.spans.get("resolve_method")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
