"""One run of one cell:

    python3 -m spgemm_bench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run makes its inputs from the seed, runs the program's set-up and
warm-up (``setup_s``: from the process's start to the window's), then
drives the cell's entry in a closed loop with one caller for ``--seconds``
(a traced run: at most the traffic's ``trace_seconds`` of it, under
``torch.profiler``, so that the trace of a mix of many short calls stays
small enough to read inside the run's time).
Every call runs from entering the program to the ``synchronize`` of its
output. A sample of the window's calls, drawn from the seed, keeps its
outputs on the host (``Sample``). Once the window has closed the run reads the peak memory, frees
the program's state and holds each kept output against the plain
reference (``reference/``), number by number against the cell's limits.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (calls in the window), ``failed`` (kept outputs outside a
limit), ``metrics`` (untraced: the end-to-end metrics; traced: the
per-layer ones), ``device`` and, traced, ``breakdown``; last, ``checks``:
each number compared with its limit. The same numbers are the last lines
of standard error.

The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell's chips), and when the JAX package, or JAX, is loaded
in the process once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import random
import subprocess
import sys
import time

import torch

from . import START, cells, inputs
from . import trace as tracing
from .drivers import sync
from .reference import compare

FORBIDDEN = ("jax", "jaxlib", "flax", "benchmark_spgemm_using_csr_tpu")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    calls: int
    window_s: float
    latencies_s: list
    setup_s: float
    work: object  # roofline.Bound of one call
    peak_bytes: int | None  # max_memory_reserved over the run; None off CUDA
    captures: int  # CUDA graph captures during the window
    profile: object | None  # trace.Profile of a traced run


class Sample:
    """A sample of the window's calls drawn from the seed: ``size``
    instants, as shares of the window's length; the first call to end
    after each instant keeps its outputs. They are copied to the host as
    soon as the call has returned, outside its timer and outside the
    window's seconds, so the card holds no output but the caller's own."""

    def __init__(self, size: int, seed: int):
        rng = random.Random(inputs.stream_seed(seed, inputs.SAMPLE))
        self.at = sorted(rng.random() for _ in range(size))
        self.kept: dict = {}

    def due(self, share: float) -> bool:
        """Whether the call that ended at ``share`` of the window is the
        first to end after an instant not yet taken."""
        hit = False
        while self.at and self.at[0] < share:
            self.at.pop(0)
            hit = True
        return hit


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _graph_captures() -> int:
    from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

    return graphs.captures


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """One run of ``cell`` on ``device``; returns the result's object.
    ``control``: hold the reference computed in bfloat16 against the
    reference, in place of the program's outputs (the comparison's control;
    not part of a benchmark run)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = cell["traffic_data"]
    module = importlib.import_module(
        f"spgemm_bench.drivers.{traffic['driver']}")
    driver = module.Driver(cell, seed, device)
    driver.setup()
    sample = Sample(int(traffic.get("sample", 3)), seed)
    latencies = []
    length = min(seconds, float(traffic["trace_seconds"])) if trace \
        else seconds
    captures0 = _graph_captures()
    setup_s = time.time() - START
    profile = None
    if trace:
        with tracing.profiled(device) as holder, \
                torch.profiler.record_function(tracing.WINDOW):
            window_s = _window(driver, sample, latencies, length, device,
                               traced=True)
        profile = holder["profile"]
    else:
        window_s = _window(driver, sample, latencies, length, device)
    captures = _graph_captures() - captures0
    peak = torch.cuda.max_memory_reserved(device) if cuda else None
    driver.release()
    readings = []
    for i in sorted(sample.kept):
        refs = driver.reference(i)
        outs = (sample.kept[i] if not control else
                [(r.rowptr, r.colidx, r.vals)
                 for r in driver.reference(i, "bfloat16")])
        if len(outs) != len(refs):
            readings.append({"struct_mismatch": abs(len(outs) - len(refs)),
                             "val_err": math.inf})
            continue
        readings += [compare.compare(*o, r) for o, r in zip(outs, refs)]
        sync(device)
    limits = cell["limits"]
    checks = {name: {"value": max((r[name] for r in readings),
                                  default=math.inf), "limit": limit}
              for name, limit in limits.items()}
    failed = sum(any(r[n] > limits[n] for n in limits) for r in readings)
    correct = bool(sample.kept) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    ctx = Context(calls=len(latencies), window_s=window_s,
                  latencies_s=latencies, setup_s=setup_s, work=driver.work(),
                  peak_bytes=peak, captures=captures,
                  profile=profile)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = cells.reader(m["name"], cell["root"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(latencies),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda
            else device.type,
            "count": cell["chips"],
            "memory_peak_bytes": int(peak or 0),
        },
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops,
                               "idle_gaps": profile.idle_gaps}
    result["checks"] = checks
    return result


def _window(driver, sample: Sample, latencies: list, length: float,
            device, traced: bool = False) -> float:
    """Drive the cell for ``length`` seconds; the window's seconds, from
    its start to the synchronize of its last call, less the copies of the
    sampled outputs to the host. A traced window annotates each call, and
    each copy, for the profile."""
    t_start = time.perf_counter()
    deadline = t_start + length
    keep_s = 0.0
    i = 0
    while True:
        x = driver.prepare(i)
        sync(device)
        t0 = time.perf_counter()
        with _annotated(tracing.CALL, traced):
            out = driver.call(x)
            sync(device)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        seconds = t1 - t_start - keep_s
        if sample.due((t1 - t_start) / length):
            with _annotated(tracing.KEEP, traced):
                sample.kept[i] = [tuple(t.to("cpu", copy=True) for t in o)
                                  for o in driver.outputs(out)]
            keep_s += time.perf_counter() - t1
        del x, out
        i += 1
        if t1 >= deadline:
            return seconds


def _annotated(name: str, traced: bool):
    return (torch.profiler.record_function(name) if traced
            else contextlib.nullcontext())


def finite(x):
    """``x`` with every number that is not finite replaced by None (JSON
    has no infinity)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def _power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m spgemm_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0
