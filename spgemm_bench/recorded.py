"""The program's own spans and counters (the port's ``utils/profiling``),
as the readers of ``metrics/`` read them.

The program records them only while a profiler records, so in a run of
the benchmark, one run a process, they are those of the traced window.
A span's reading is None where the program recorded no such span. A
counter reads 0 where the program recorded other spans or counters but
never this one (the window's calls never reached it), and None where it
recorded nothing: a program without the recorder, or a run untraced."""


def _totals():
    from benchmark_spgemm_using_csr_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    return None if totals is None else totals()


def span_seconds(name: str):
    """The seconds the program spent in span ``name``, or None."""
    totals = _totals()
    if totals is None or name not in totals["spans"]:
        return None
    return totals["spans"][name][1]


def counter(name: str):
    """Counter ``name`` of the program (module docstring), or None."""
    totals = _totals()
    if totals is None or not (totals["spans"] or totals["counters"]):
        return None
    return totals["counters"].get(name, 0)


def per_call(value, ctx, scale: float = 1.0):
    """``value`` over the window's calls, times ``scale``; None where
    ``value`` is."""
    if value is None or not ctx.calls:
        return None
    return value / ctx.calls * scale
