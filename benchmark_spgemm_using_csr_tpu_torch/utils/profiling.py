"""Tracing and stage timing (the reference package's ``utils/profiling.py``
on ``torch.profiler``): a Chrome trace of a block, device time summed by
kernel name, and a stage timer that pairs with ``utils/roofline``'s stage
models.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


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
    totals: dict[str, float] = {}
    for evt in prof.key_averages():
        t = evt.device_time_total  # microseconds
        if (t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("ProfilerStep")):
            totals[evt.key] = totals.get(evt.key, 0.0) + t * 1e-6
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def _sync(x) -> None:
    """Wait for the device work behind every tensor in ``x`` (a tensor, or
    a container or dataclass of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _sync(y)
    elif isinstance(x, dict):
        for y in x.values():
            _sync(y)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            _sync(getattr(x, name))


class StageTimer:
    """Host-clock stage timer: ``stage(name, holder)`` times its block and,
    before reading the clock, synchronises the device of the last result in
    ``holder`` (a list the block appends to), so the time covers the work
    the block enqueued."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: list | None = None):
        t0 = time.perf_counter()
        yield
        if result_holder:
            _sync(result_holder[-1])
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(self.stages)
