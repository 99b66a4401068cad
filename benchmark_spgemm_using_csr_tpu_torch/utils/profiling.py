"""The port's one tracing system: spans and counters recorded inside the
program, a Chrome trace of a block, and device time summed by kernel.

Spans and counters record only while tracing is on: while a
``torch.profiler`` records (``torch._C._autograd._profiler_enabled()``:
true in a profile's active step, false in its warm-up step and after it)
or inside ``recording()`` (for a caller without a profiler, and tests).
Off, ``span`` and ``count`` read the two switches and return: no clock,
no annotation, no allocation. On, a span

- adds its ``time.perf_counter`` duration and one call to the registry;
- while a profiler records, also opens a
  ``torch.profiler.record_function`` annotation of its name, so it lies
  on the profiler's host clock beside the device's intervals (without a
  profiler nothing reads it, and it costs ~9 us a span on an H100
  machine's host, against ~1 us for the rest of the span).

A span never synchronises the device: it times what the host spent in
it, enqueueing included and the device's work after it not.
``totals()`` gives the registry since the last ``reset()``.

The spans and counters the program records (PERF.md §3 lists them, with
the metric that reads each): spans ``api.spgemm``, ``api.plan``,
``dispatch.choose``, ``dispatch.stats``, ``dispatch.estimate.<method>``,
``host.copy``, ``graphs.eager``, ``graphs.capture``, ``graphs.replay``,
``dia.spgemm``, ``dia.to_csr``, ``amg.refresh``, ``chunked.spgemm``,
``grouped.spgemm``;
counters ``graphs.copy_bytes`` (bytes a replay copies into its static
inputs and clones out of its outputs), ``host.d2h_bytes`` (bytes
``host_view`` copies to the host), ``host.syncs`` (the points where the
program blocks the host on the device: a host copy, a scalar read, a
shape-dependent op), ``chunked.slots`` and ``chunked.out_slots`` (the
product-stream and output slots of a chunked call's plan),
``grouped.slots`` (the product slots of a grouped call's plan).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
# depth of recording() blocks
_forced = 0
# name -> (calls, seconds); name -> count
_spans: dict = {}
_counters: dict = {}
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "annotation", "t0")

    def __init__(self, name: str, annotate: bool):
        self.name = name
        self.annotation = (torch.profiler.record_function(name) if annotate
                           else None)

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        n, total = _spans.get(self.name, (0, 0.0))
        _spans[self.name] = (n + 1, total + seconds)
        return False


def span(name: str):
    """A context that records the enclosed block as span ``name`` while
    tracing is on (module docstring), and a shared no-op context off."""
    if _profiler_enabled():
        return _Span(name, annotate=True)
    return _Span(name, annotate=False) if _forced else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _forced or _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record spans and counters within the block, profiler or not."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def totals() -> dict:
    """``{"spans": {name: (calls, seconds)}, "counters": {name: n}}``
    recorded since the last ``reset()``."""
    return {"spans": dict(_spans), "counters": dict(_counters)}


def reset() -> None:
    """Forget every recorded span and counter."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    plus CUDA where ``cuda``, by default when a card is present) and write
    ``<logdir>/trace.json``, a Chrome trace (chrome://tracing or Perfetto).
    Yields the profiler, whose ``key_averages()`` stay readable after the
    block.

    The block is the profiler's one active step, after a warm-up step of a
    few small ops whose records are discarded: without it the device
    records of the first ~25 operations after the start were lost (seen
    on an H100 host)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path),
                 acc_events=True) as prof:
        x = torch.zeros(1, device="cuda" if cuda else "cpu")
        for _ in range(32):
            x.add_(1)
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        prof.step()


def device_time_by_kernel(prof) -> dict[str, float]:
    """Device seconds of a finished profile, summed by kernel (and copy)
    name, largest first (empty when no device activity was recorded). The
    schedule's step marker, which spans its step's kernels, is left out."""
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        t = evt.device_time_total  # microseconds
        if (t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("ProfilerStep")):
            by_name[evt.key] = by_name.get(evt.key, 0.0) + t * 1e-6
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
