"""The traced run's profile: ``torch.profiler`` over the window, exported
as a Chrome trace to a temporary directory and reduced to what the
per-layer metrics and the breakdown read.

The profile's first step is a few small operations whose records are
dropped: without it the device records of the first operations after the
profiler starts were lost on an H100 host (the program's
``utils/profiling.trace`` found this; the same recipe is used here).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

WINDOW = "spgemm_bench.window"
CALL = "spgemm_bench.call"
# the copy of a sampled output to the host: the benchmark's own, left out
# of the window (its length, its device activity and its idle gaps)
KEEP = "spgemm_bench.keep"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# the longest gaps that are labelled by what the host was doing
LABELLED_GAPS = 500
TOP = 10
# a name longer than this is cut (C++ kernel names run to thousands)
NAME_CHARS = 160


@dataclasses.dataclass
class Profile:
    """A traced window (less the copies of sampled outputs, ``KEEP``): its
    length, the union of its device activity, the part of that union
    inside the calls (``CALL`` annotations: the input
    each call is handed is made outside them), the device seconds by
    operation name and the idle seconds by what the host was doing (the
    longest gaps), largest first."""

    window_s: float
    busy_s: float
    call_busy_s: float
    device_ops: list
    idle_gaps: list


@contextlib.contextmanager
def profiled(device):
    """Profile the enclosed block; ``holder["profile"]`` is its
    ``Profile`` once the block has ended. The block must run inside
    ``torch.profiler.record_function(WINDOW)``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    holder: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path),
                     acc_events=True) as prof:
            x = torch.zeros(1, device=device)
            for _ in range(32):
                x.add_(1)
            if cuda:
                torch.cuda.synchronize(device)
            prof.step()
            yield holder
            if cuda:
                torch.cuda.synchronize(device)
            prof.step()
        with open(path) as f:
            holder["profile"] = reduce(json.load(f))


def _union(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def _overlap(a_s, a_e, b_s, b_e) -> float:
    """The length of the intersection of two unions of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a_s) and j < len(b_s):
        lo, hi = max(a_s[i], b_s[j]), min(a_e[i], b_e[j])
        if hi > lo:
            total += hi - lo
        if a_e[i] < b_e[j]:
            i += 1
        else:
            j += 1
    return total


def _annotations(events: list, name: str):
    """(starts, ends) of the host annotations ``name``."""
    ann = [x for x in events if x.get("name") == name
           and x.get("cat") == "user_annotation"]
    st = np.array([float(x["ts"]) for x in ann], dtype=np.float64)
    return st, st + np.array([float(x["dur"]) for x in ann],
                             dtype=np.float64)


def reduce(trace: dict) -> Profile:
    """A ``Profile`` of the window annotation ``WINDOW`` in a Chrome trace
    (times in microseconds)."""
    events = [x for x in trace.get("traceEvents", []) if x.get("ph") == "X"]
    win = [x for x in events if x.get("name") == WINDOW
           and x.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ks, ke = _annotations(events, KEEP)
    ks, ke = _union(np.clip(ks, w0, w1), np.clip(ke, w0, w1))
    dev = [x for x in events if x.get("cat") in DEVICE_CATS]
    start = np.array([float(x["ts"]) for x in dev], dtype=np.float64)
    dur = np.array([float(x.get("dur", 0)) for x in dev], dtype=np.float64)
    s = np.clip(start, w0, w1)
    e = np.clip(start + dur, w0, w1)
    # device activity of a copy of a sampled output is not the program's
    mid = 0.5 * (s + e)
    k = np.searchsorted(ks, mid, side="right") - 1
    own = ~((k >= 0) & (mid < np.append(ke, -np.inf)[k]))
    dev = [x for x, o in zip(dev, own) if o]
    s, e = s[own], e[own]
    names = [x["name"][:NAME_CHARS] for x in dev]
    totals: dict = {}
    for name, d in zip(names, e - s):
        if d > 0:
            totals[name] = totals.get(name, 0.0) + float(d) * 1e-6
    us, ue = _union(s, e)
    busy = float((ue - us).sum())
    cs, ce = _union(*_annotations(events, CALL))
    call_busy = _overlap(us, ue, cs, ce)
    # idle gaps inside the window and outside the copies, the longest
    # labelled by the innermost host event that covers the gap's middle
    bs, be = _union(np.concatenate([us, ks]), np.concatenate([ue, ke]))
    gs = np.concatenate([[w0], be])
    ge = np.concatenate([bs, [w1]])
    gaps = ge - gs
    pos = gaps > 0
    gs, ge, gaps = gs[pos], ge[pos], gaps[pos]
    host = [x for x in events if x.get("cat") in HOST_CATS
            and x.get("name") not in (WINDOW, CALL, KEEP)
            and not x.get("name", "").startswith("ProfilerStep")]
    hs = np.array([float(x["ts"]) for x in host], dtype=np.float64)
    he = hs + np.array([float(x.get("dur", 0)) for x in host],
                       dtype=np.float64)
    idle: dict = {}
    for g in np.argsort(-gaps, kind="stable")[:LABELLED_GAPS]:
        mid = 0.5 * (gs[g] + ge[g])
        cover = np.flatnonzero((hs <= mid) & (he >= mid)) if host else []
        label = (host[cover[np.argmin(he[cover] - hs[cover])]]["name"]
                 if len(cover) else "host, outside any recorded operation")
        label = label[:NAME_CHARS]
        idle[label] = idle.get(label, 0.0) + float(gaps[g]) * 1e-6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    kept = float((ke - ks).sum())
    return Profile(window_s=(w1 - w0 - kept) * 1e-6, busy_s=busy * 1e-6,
                   call_busy_s=float(call_busy) * 1e-6,
                   device_ops=[[k, v] for k, v in top],
                   idle_gaps=[[k, v] for k, v in gaps_top])
