"""Suite benchmark of the port: C = A @ A GFlops over the synthetic
SuiteSparse-regime suite on one card, every point checked against scipy.

    python -m benchmark_spgemm_using_csr_tpu_torch.bench [--device cuda|cpu]
        [--results bench_out/results_torch.jsonl]

The counterpart of the JAX package's root ``bench.py``: the same points in
the same order, and its headline line, key for key, as the last line of
stdout. Progress goes to stderr, one line a point. The points:

1. the 22 suite matrices (``SUITE_NAMES``, ``utils/generators.SUITE``),
   each through the dispatcher's pick (``ops/dispatch.choose_method``);
2. the rectangular pair ``rect_96k_24k_48k`` (``generators.SUITE_PAIRS``)
   through the cheapest of chunked, grouped and tilepack by their
   estimators;
3. ``dense_rows_8k_ooc``: dense_rows_8k forced through the out-of-core
   ``ops/batched.spgemm_batched``, timed as wall clock (three calls, the
   first, which builds the plan, excluded);
4. the float64 mini-suite (``F64_POINTS``), each point on the backend the
   reference forces for it and verified against x64 scipy at rtol/atol
   1e-12; beside it the same matrix in float32 on the same backend, whose
   ratio is reported;
5. ``rap_poisson2d_256``: R·A·P with P from
   ``models/amg.aggregation_prolongator``, by three routes: two chained
   products (each the cheapest of chunked, grouped and tilepack), the
   triple plan (``ops/reuse``) and ``ops/aggrap``; the fastest counts.

The 23 points of 1 and 2 are scored: ``value`` is the geometric mean of
their GFlops, GFlops = flops / t / 1e9 with flops = 2 * nnzCt
(``api.spgemm_flops``) and t the median time of the numeric phase: the
method's host plan (for dia: the DIA planes; for bsr: the BSR operands)
is built before, outside the timed window, and each run is timed by CUDA
events (``utils/timing.bench``, 2 warmups, 5 runs; on the card a
chunked, grouped, tilepack or bsr phase replays its CUDA graph,
``ops/graphs``, as do the triple and aggrap routes of R·A·P);
``spread`` is (max - min) / median. Beside it: the whole call
``api.spgemm(a, b, method="auto")`` once on the host clock, host planning
and dispatch included, with the graphs dropped first so that it runs
eager, as a one-shot caller's call does, and the method it ran; the peak device memory above the
point's start; the ``_bound`` and plan-aware ``_total`` roofline shares
of the numeric median (``utils/roofline``), None off the card.
``vs_baseline`` is ``value`` against 1.0 GFlops, as the reference's.

Every C is held against scipy's product by ``utils/oracle.assert_csr_equal``:
the structure exactly and the values within the tolerance, exact zeros
pruned on both sides (DIA's in-plane and BSR's in-block zeros are no
entries of C). An entry whose sum cancels may round to exactly 0 in one
order of addition and not in the other; such an entry may lie in one
structure only if its value is within the rounding bound of its terms
(``utils/oracle.cancellation_bound``, from the scipy operands), and the
row counts them (``one_side_entries``). dia's numeric phase ends in C's
CSR (``DIA.to_csr``, as the port's numeric phase of dia does everywhere);
the reference's kept C in planes.

A point fails when it raises, when its C disagrees with scipy, when a
roofline share exceeds 1.0 (the model would not be a lower bound), or when
its method has no plan to build outside the timed window: hash, or a
tilepack or grouped plan that refuses the matrix. Nothing is swapped in.
A failed point is named in ``detail.failed``, its reason goes to stderr and
to its row, and the run exits 1 after the headline.

One row a measured point goes to ``--results`` (JSON lines). Each finished
point snapshots the headline to ``.bench_partial.json`` in that directory,
removed at the end of a run. SIGTERM, SIGINT and SIGALRM print the headline
of the points done so far with ``"partial": true`` and exit 128 + the
signal. Environment: ``BENCH_BUDGET_S`` trims the repeats (5, then 3 past
half the budget, 1 past three quarters; membership never) and sets an
alarm 45 s before the budget; ``BENCH_ONLY=name,...`` runs only the named
points (suite and pair names, the ``*_f64`` names, ``dense_rows_8k_ooc``,
``rap_poisson2d_256``), and the headline says ``"partial": true``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import api
from .ops import dia_kernels, dispatch, graphs, kernels
from .sparse.csr import BSR, CSR
from .sparse.dia import DIA
from .utils import generators
from .utils.oracle import TOLERANCES, assert_csr_equal, spgemm_reference
from .utils.results import write_result
from .utils.roofline import (
    batched_dense_stage_models,
    roofline_report,
    spgemm_models,
)
from .utils.timing import bench

# the reference bench's scored suite, in its order (bench.py:199-238)
SUITE_NAMES = (
    "er_medium", "powerlaw_medium", "poisson2d_256", "banded_16k",
    "stencil27_32", "circuit_64k", "dense_rows_2k", "webbase_1m",
    "econ_206k", "mc2depi_524k", "scircuit_256k", "dense_rows_8k",
    "fem_17k", "fem_32k", "pdb_8k", "femirr_17k", "pattern_circuit_64k",
    "hubrows_32k", "fem_46k", "road_1m", "smallworld_400k", "consph_83k",
)
PAIR_NAMES = tuple(generators.SUITE_PAIRS)
# the earlier, smaller suites whose gmeans the reference also reports
R1_NAMES = ("er_medium", "powerlaw_medium", "poisson2d_256", "banded_16k",
            "stencil27_32", "circuit_64k", "dense_rows_2k")
R2_NAMES = R1_NAMES + ("webbase_1m", "econ_206k", "mc2depi_524k",
                       "scircuit_256k", "dense_rows_8k")
OOC_POINT, OOC_MATRIX = "dense_rows_8k_ooc", "dense_rows_8k"
# point -> (forced method, suite matrix); the reference's bench.py:739-757
F64_POINTS = {
    "er_small_f64": ("grouped", "er_small"),
    "poisson2d_256_f64": ("dia", "poisson2d_256"),
    "fem_17k_f64": ("dia", "fem_17k"),
    "dense_rows_2k_f64": ("dense", "dense_rows_2k"),
    "scircuit_f64": ("grouped", "scircuit_256k"),
    "banded_16k_f64": ("bsr", "banded_16k"),
}
RAP_POINT, RAP_MATRIX = "rap_poisson2d_256", "poisson2d_256"
POINTS = SUITE_NAMES + PAIR_NAMES + (OOC_POINT,) + tuple(F64_POINTS) + (
    RAP_POINT,)
F32_TOL = TOLERANCES["float32"]  # the CLI's
F64_TOL = dict(rtol=1e-12, atol=1e-12)  # the f64 mini-suite's, against x64 scipy
RAP_TOL = dict(rtol=1e-3, atol=1e-4)  # the reference bench's (bench.py:968)
BSR_BLOCKS = ((8, 128), (128, 128))  # A's and B's blocks (bench.py:426)
OOC_BUDGET = 64 << 20  # spgemm_batched's default stream budget, in products
WARMUP = 2
RUNS = 5
DEFAULT_RESULTS = os.path.join("bench_out", "results_torch.jsonl")
PARTIAL_FILE = ".bench_partial.json"
# the launch counts of the hand-written kernels
KERNELS = {
    "tile_sort_merge": kernels.tile_sort_merge,
    "bin_sort_compress": kernels.bin_sort_compress,
    "dia_spgemm_fused": dia_kernels.dia_spgemm_fused,
}


class PointFailed(Exception):
    """A point that cannot be measured as the harness defines it."""


def runs_for(elapsed_s: float, budget_s: float, runs: int = RUNS) -> int:
    """Timed runs a point gets: ``runs``, at most 3 past half the budget,
    1 past three quarters (no budget: ``runs``)."""
    if not budget_s or elapsed_s < 0.5 * budget_s:
        return runs
    return min(runs, 3) if elapsed_s < 0.75 * budget_s else 1


def gmean(values) -> float:
    values = list(values)
    if not values:
        return 0.0
    return float(np.exp(np.mean([np.log(max(v, 1e-12)) for v in values])))


def card_text(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None on the
    CPU."""
    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def counted(fn, device):
    """(fn(), launches of each hand-written kernel during it)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    sync(device)
    return out, {name: k.launches for name, k in KERNELS.items()}


class Peak:
    """Device memory above a start: ``gib()`` reads the peak since it."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            self.base = torch.cuda.memory_allocated(device)

    def gib(self) -> float | None:
        if not self.cuda:
            return None
        peak = torch.cuda.max_memory_allocated(self.device)
        return (peak - self.base) / 2 ** 30


def verify(c, want, tol, factors) -> int:
    """Hold C against scipy's ``want``, the product of the scipy
    ``factors``, with exact zeros pruned on both sides and cancelled
    entries admitted within their rounding bound
    (``utils/oracle.assert_csr_equal``); returns the count of those
    entries. Raises AssertionError."""
    return assert_csr_equal(c, want, check_explicit_zeros=False,
                            factors=factors, **tol)


def pair_method(a: CSR, b: CSR) -> str:
    """The cheapest of chunked, grouped and tilepack by their estimators
    (the reference bench's choice for the pair and the chained R·A·P)."""
    est = {
        "chunked": dispatch.estimate_chunked_s(a, b),
        "grouped": dispatch.estimate_grouped_s(a, b),
        "tilepack": dispatch.estimate_tilepack_s(a, b),
    }
    return min(est, key=est.get)


def csr_plan(a: CSR, b: CSR, method: str):
    """(plan, run) of a CSR method: its host plan for A @ B, and
    ``run(u, v)``, the numeric phase on operands of A's and B's structure.
    A plan that refuses the operands fails the point."""
    if method == "tilepack":
        from .ops.tilepack import make_tilepack_plan, spgemm_tilepack

        plan, run = make_tilepack_plan(a, b), spgemm_tilepack
    elif method == "grouped":
        from .ops.grouped import make_grouped_plan, spgemm_grouped

        plan, run = make_grouped_plan(a, b), spgemm_grouped
    elif method == "chunked":
        from .ops.chunked import make_chunked_plan, spgemm_chunked

        plan, run = make_chunked_plan(a, b), spgemm_chunked
    elif method == "dense":
        from .ops.dense import make_dense_plan, spgemm_dense

        plan, run = make_dense_plan(a, b), spgemm_dense
    else:
        raise PointFailed(f"{method} has no plan to build outside the timed "
                          f"window")
    if plan is None:
        raise PointFailed(f"{method}'s plan refuses the operands")
    return plan, lambda u, v: run(u, v, plan)


def numeric_phase(a: CSR, b: CSR, method: str, a_sp, b_sp):
    """(plan, fn): ``method``'s host plan (dia: the DIA planes, bsr: the BSR
    operands and plan) built here, and fn(), the numeric phase on it."""
    dev = a.device
    if method == "dia":
        from .ops.dia import dia_spgemm

        a_d = DIA.from_scipy(a_sp, device=dev)
        b_d = a_d if b_sp is a_sp else DIA.from_scipy(b_sp, device=dev)
        return None, lambda: dia_spgemm(a_d, b_d).to_csr(prune=True)
    if method == "bsr":
        from .ops.bsr import bsr_spgemm, make_bsr_plan

        a_b = BSR.from_scipy(a_sp, BSR_BLOCKS[0], device=dev)
        b_b = BSR.from_scipy(b_sp, BSR_BLOCKS[1], device=dev)
        plan = make_bsr_plan(a_b, b_b)
        return plan, lambda: bsr_spgemm(a_b, b_b, plan)
    plan, run = csr_plan(a, b, method)
    return plan, lambda: run(a, b)


def roofline_shares(models, bound, seconds, device) -> dict:
    """The ``_bound`` and plan-aware ``_total`` shares of a measured time
    (None off the card), with what bounds ``_bound``."""
    rep = roofline_report(models, total_time_s=seconds, bound=bound,
                          measured_on=device)
    return {"bound_share": rep["_bound"]["sol_fraction"],
            "bound_by": rep["_bound"]["bound_by"],
            "total_share": rep["_total"]["sol_fraction"],
            "roofline_chip": rep["_total"]["chip"]}


def check_shares(row: dict) -> None:
    over = [k for k in ("bound_share", "total_share")
            if row.get(k) is not None and row[k] > 1.0]
    if over:
        raise PointFailed(f"roofline share over 1.0: "
                          f"{ {k: row[k] for k in over} }")


def timed_fields(num, flops: int) -> dict:
    """A row's numbers from a ``utils/timing.bench`` result."""
    return {"numeric_ms": num.median_s * 1e3,
            "numeric_runs_ms": [t * 1e3 for t in num.times],
            "spread": (max(num.times) - min(num.times)) / num.median_s,
            "gflops": flops / num.median_s / 1e9}


def spgemm_point(name, a_sp, b_sp=None, *, device, runs=RUNS, method=None,
                 want=None, tol=F32_TOL, whole=True) -> dict:
    """One point: C = A @ B (B = A when ``b_sp`` is None) from scipy
    operands. ``method`` None takes the dispatcher's pick. ``whole`` also
    times and verifies ``api.spgemm(a, b, method="auto")`` once. Returns
    the point's row; raises PointFailed or AssertionError if it fails."""
    square = b_sp is None
    b_sp = a_sp if square else b_sp
    peak = Peak(device)
    a = CSR.from_scipy(a_sp, device=device)
    b = a if square else CSR.from_scipy(b_sp, device=device)
    flops = api.spgemm_flops(a, b)
    pick = dispatch.choose_method(a, b) if method is None else method
    t0 = time.perf_counter()
    plan, fn = numeric_phase(a, b, pick, a_sp, b_sp)
    sync(device)
    plan_s = time.perf_counter() - t0
    want = spgemm_reference(a_sp, b_sp) if want is None else want
    c, launches = counted(fn, device)
    one_side = verify(c, want, tol, (a_sp, b_sp))
    del c
    num = bench(fn, device=device, name=name, warmup=WARMUP, runs=runs,
                flops=flops)
    row = {
        "matrix": name, "method": pick,
        "dtype": str(a.dtype).removeprefix("torch."), "shape": [a.m, b.n],
        "nnz_a": int(a_sp.nnz), "flops": flops, "nnz_c": int(want.nnz),
        "plan_ms": plan_s * 1e3, **timed_fields(num, flops),
    }
    if whole:
        row["auto_method"] = api.resolve_method(a, b)
        # the numeric calls above captured this plan's graph: drop it, so
        # the whole call runs eager, as a one-shot caller's does
        graphs.clear()
        sync(device)
        t0 = time.perf_counter()
        c, got = counted(lambda: api.spgemm(a, b, method="auto"), device)
        row["whole_call_ms"] = (time.perf_counter() - t0) * 1e3
        one_side = max(one_side, verify(c, want, tol, (a_sp, b_sp)))
        del c
        launches = {k: launches[k] + got[k] for k in KERNELS}
    row["one_side_entries"] = one_side
    row["launches"] = launches
    row["peak_gib"] = peak.gib()
    models, bound = spgemm_models(a, b, CSR.from_scipy(want, device="cpu"),
                                  pick, planes=pick == "dia", plan=plan)
    row.update(roofline_shares(models, bound, num.median_s, device))
    row["verified"] = True
    check_shares(row)
    return row


class Harness:
    """One run of the points on ``device``: ``run()`` measures every point
    that ``only`` admits (all when empty) and keeps the headline's state;
    ``headline()`` gives the headline object. ``say`` receives one line a
    point."""

    def __init__(self, *, device, runs=RUNS, results=DEFAULT_RESULTS,
                 only=(), budget_s=0.0, say=None):
        unknown = sorted(set(only) - set(POINTS))
        if unknown:
            raise ValueError(f"unknown points {unknown}; have {POINTS}")
        self.device = torch.device(device)
        self.runs = runs
        self.results = results
        self.partial_path = os.path.join(os.path.dirname(results) or ".",
                                         PARTIAL_FILE)
        self.only = frozenset(only)
        self.budget_s = budget_s
        self.say = say or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))
        self.card = card_text(self.device)
        self.t0 = time.perf_counter()
        self.per_matrix: dict = {}  # scored points and the ooc point
        self.f64: dict = {}  # f64 point -> GFlops
        self.f64_vs_f32: dict = {}  # f64 point -> its GFlops / float32's
        self.rap: dict = {}
        self.failed: dict = {}  # point -> reason
        self.rows: list = []
        self._wants: dict = {}  # scipy products two points share

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def runs_now(self) -> int:
        return runs_for(self.elapsed(), self.budget_s, self.runs)

    def run(self) -> "Harness":
        for name in SUITE_NAMES:
            self.point(name, self.suite_point, name)
        for name in PAIR_NAMES:
            self.point(name, self.pair_point, name)
        self.point(OOC_POINT, self.ooc_point)
        self._wants.clear()
        for name in F64_POINTS:
            self.point(name, self.f64_point, name)
        self.point(RAP_POINT, self.rap_point)
        if os.path.exists(self.partial_path):
            os.remove(self.partial_path)
        return self

    # ---- bookkeeping -------------------------------------------------------

    def point(self, name, fn, *args) -> None:
        """Measure one point if ``only`` admits it; a point that raises is
        recorded as failed and the run goes on to the next."""
        if self.only and name not in self.only:
            return
        self.say(f"{name}: started at {self.elapsed():.1f} s")
        try:
            fn(*args)
        except Exception as e:  # recorded, reported, and the run exits 1
            traceback.print_exc(file=sys.stderr)
            self.failed[name] = f"{type(e).__name__}: {e}"[:2000]
            self.record({"matrix": name, "verified": False,
                         "error": self.failed[name]})
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        self.snapshot()

    def record(self, row: dict) -> None:
        row = {**row, "device": self.card or "cpu", "elapsed_s":
               self.elapsed()}
        self.rows.append(row)
        write_result(self.results, row)
        self.say(line(row))

    def snapshot(self) -> None:
        """The would-be headline, kept after every point (a kill that no
        handler sees leaves it behind)."""
        os.makedirs(os.path.dirname(self.partial_path) or ".", exist_ok=True)
        with open(self.partial_path, "w") as f:
            f.write(json.dumps(self.headline(partial=True)) + "\n")

    def want(self, name, a_sp):
        """scipy's A @ A of suite matrix ``name``, kept for the in-core and
        out-of-core dense_rows_8k points."""
        if name not in self._wants:
            self._wants[name] = spgemm_reference(a_sp, a_sp)
        return self._wants[name]

    # ---- the points ---------------------------------------------------------

    def suite_point(self, name) -> None:
        a_sp = generators.SUITE[name]()
        want = self.want(name, a_sp) if name == OOC_MATRIX else None
        row = spgemm_point(name, a_sp, device=self.device,
                           runs=self.runs_now(), want=want)
        self.per_matrix[name] = row
        self.record(row)

    def pair_point(self, name) -> None:
        a_sp, b_sp = generators.SUITE_PAIRS[name]()
        a = CSR.from_scipy(a_sp, device=self.device)
        b = CSR.from_scipy(b_sp, device=self.device)
        method = pair_method(a, b)
        del a, b
        row = spgemm_point(name, a_sp, b_sp, device=self.device,
                           runs=self.runs_now(), method=method)
        self.per_matrix[name] = row
        self.record(row)

    def ooc_point(self) -> None:
        from .ops import batched

        a_sp = generators.SUITE[OOC_MATRIX]()
        want = self.want(OOC_MATRIX, a_sp)
        peak = Peak(self.device)
        a = CSR.from_scipy(a_sp, device=self.device)
        flops = api.spgemm_flops(a, a)
        walls, launches = [], {}
        for _ in range(3):
            sync(self.device)
            t0 = time.perf_counter()
            c, launches = counted(
                lambda: batched.spgemm_batched(a, a, OOC_BUDGET), self.device)
            walls.append(time.perf_counter() - t0)
        wall = min(walls[1:])  # the first call builds the plan
        one_side = verify(c, want, F32_TOL, (a_sp, a_sp))
        del c
        plan = batched._cached_plan(a, a, OOC_BUDGET, None)  # the calls' plan
        models, bound = spgemm_models(
            a, a, CSR.from_scipy(want, device="cpu"), plan.method)
        if plan.method == "dense":
            models = batched_dense_stage_models(plan, a.n, a.n, int(a_sp.nnz))
        in_core = self.per_matrix.get(OOC_MATRIX, {})
        row = {
            "matrix": OOC_POINT, "method": f"batched/{plan.method}",
            "dtype": str(a.dtype).removeprefix("torch."),
            "shape": [a.m, a.n],
            "nnz_a": int(a_sp.nnz), "flops": flops, "nnz_c": int(want.nnz),
            "row_blocks": len(plan.blocks), "wall_ms": wall * 1e3,
            "walls_ms": [w * 1e3 for w in walls],
            "gflops": flops / wall / 1e9, "one_side_entries": one_side,
            "launches": launches,
            "peak_gib": peak.gib(),
            "in_core_peak_gib": in_core.get("peak_gib"),
            **roofline_shares(models, bound, wall, self.device),
            "verified": True,
        }
        check_shares(row)
        self.per_matrix[OOC_POINT] = row
        self.record(row)

    def f64_point(self, name) -> None:
        method, member = F64_POINTS[name]
        a64 = generators.SUITE[member]().astype(np.float64)
        rng = np.random.default_rng(0)
        a64.data = a64.data * (1.0 + 1e-8 * rng.standard_normal(a64.nnz))
        row = spgemm_point(name, a64, device=self.device,
                           runs=self.runs_now(), method=method, tol=F64_TOL,
                           whole=False)
        sibling = spgemm_point(name, a64.astype(np.float32),
                               device=self.device, runs=self.runs_now(),
                               method=method, whole=False)
        row["vs_f32"] = row["gflops"] / sibling["gflops"]
        self.record(sibling)
        self.f64[name] = row["gflops"]
        self.f64_vs_f32[name] = row["vs_f32"]
        self.record(row)

    def rap_point(self) -> None:
        from .models.amg import aggregation_prolongator
        from .ops.aggrap import make_aggrap_plan, rap_aggregation
        from .ops.reuse import make_triple_plan, spgemm_triple

        dev = self.device
        a_sp = generators.SUITE[RAP_MATRIX]()
        p_sp = aggregation_prolongator(a_sp).astype(np.float32).tocsr()
        r_sp = p_sp.T.tocsr()
        a, p, r = (CSR.from_scipy(x, device=dev) for x in (a_sp, p_sp, r_sp))
        f64 = [x.astype(np.float64) for x in (r_sp, a_sp, p_sp)]
        want = spgemm_reference(*f64)
        peak = Peak(dev)
        m1 = pair_method(a, p)
        _, run1 = csr_plan(a, p, m1)
        ap = run1(a, p)
        m2 = pair_method(r, ap)
        _, run2 = csr_plan(r, ap, m2)
        flops = api.spgemm_flops(a, p) + api.spgemm_flops(r, ap)
        del ap
        triple = make_triple_plan(r, a, p)
        agg = make_aggrap_plan(r, a, p)
        if triple is None or agg is None:
            raise PointFailed(f"a plan refuses {RAP_MATRIX}: triple "
                              f"{triple is not None}, aggrap "
                              f"{agg is not None}")
        routes = {
            f"chained {m1}+{m2}": lambda: run2(r, run1(a, p)),
            "triple": lambda: spgemm_triple(r, a, p, triple),
            "aggrap": lambda: rap_aggregation(a, agg),
        }
        best = None
        for route, fn in routes.items():
            c, launches = counted(fn, dev)
            one_side = verify(c, want, RAP_TOL, f64)
            del c
            num = bench(fn, device=dev, name=route, warmup=WARMUP,
                        runs=self.runs_now(), flops=flops)
            row = {
                "matrix": RAP_POINT, "method": route, "dtype": "float32",
                "shape": [r.m, p.n], "nnz_a": int(a_sp.nnz), "flops": flops,
                "nnz_c": int(want.nnz), **timed_fields(num, flops),
                "one_side_entries": one_side, "launches": launches,
                "peak_gib": peak.gib(), "verified": True,
            }
            self.record(row)
            if best is None or row["gflops"] > best["gflops"]:
                best = row
        self.rap[RAP_POINT] = best["gflops"]
        self.rap[f"{RAP_POINT}_route"] = best["method"]

    # ---- the headline -------------------------------------------------------

    def headline(self, partial: bool = False) -> dict:
        """The reference bench's headline (bench.py:127-172), key for key,
        with the card, the failed points and the float64 ratios added."""
        scored = {k: v for k, v in self.per_matrix.items()
                  if not k.endswith("_ooc")}
        value = gmean(v["gflops"] for v in scored.values())

        def basis(names):
            return gmean(scored[k]["gflops"] for k in names if k in scored)

        detail = {k: round(v["gflops"], 4) for k, v in self.per_matrix.items()}
        detail.update({k: round(v, 4) for k, v in self.f64.items()})
        detail.update({f"{k}_vs_f32": round(v, 4)
                       for k, v in self.f64_vs_f32.items()})
        if self.f64:
            detail["gmean_f64"] = round(gmean(self.f64.values()), 4)
        detail.update({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in self.rap.items()})
        detail.update({
            "n_scored": len(scored),
            "spread_max": round(max((v.get("spread", 0.0)
                                     for v in self.per_matrix.values()),
                                    default=0.0), 4),
            "gmean_r1suite": round(basis(R1_NAMES), 4),
            "gmean_r2suite": round(basis(R2_NAMES), 4),
            "device": self.card,
            "failed": sorted(self.failed),
        })
        if partial or self.only:
            detail["partial"] = True
            detail["elapsed_s"] = round(self.elapsed(), 1)
        return {
            "metric": "spgemm_gflops_gmean_1chip",
            "value": round(value, 4),
            "unit": "GFlops",
            "vs_baseline": round(value / 1.0, 4),
            "detail": detail,
        }


def _fmt(x, spec="{:.3f}") -> str:
    return "-" if x is None else spec.format(x)


def line(row: dict) -> str:
    """One human-readable line of a point's row."""
    name = row["matrix"]
    if not row.get("verified"):
        return f"{name}: FAILED: {row.get('error')}"
    text = (f"{name}: {row['method']} {row['dtype']}, {row['flops']} flops, "
            f"nnzC {row['nnz_c']}, verified")
    if "numeric_ms" in row:
        text += (f"; numeric median {row['numeric_ms']:.3f} ms (spread "
                 f"{row['spread']:.1%}) = {row['gflops']:.3f} GFlops")
    if "wall_ms" in row:
        text += (f"; wall {row['wall_ms']:.1f} ms (calls "
                 f"{', '.join(f'{w:.1f}' for w in row['walls_ms'])}) = "
                 f"{row['gflops']:.3f} GFlops")
    if "plan_ms" in row:
        text += f"; plan {row['plan_ms']:.1f} ms"
    if "whole_call_ms" in row:
        text += (f"; whole call {row['whole_call_ms']:.1f} ms "
                 f"(auto ran {row['auto_method']})")
    if row.get("one_side_entries"):
        text += (f"; {row['one_side_entries']} entries in one structure "
                 f"only, within their sums' rounding bound")
    if "vs_f32" in row:
        text += f"; {row['vs_f32']:.3f}x float32's GFlops"
    if "bound_share" in row:
        text += (f"; _bound {_fmt(row['bound_share'], '{:.2%}')} "
                 f"({row['bound_by']}), _total "
                 f"{_fmt(row['total_share'], '{:.2%}')}")
    text += f"; peak {_fmt(row['peak_gib'])} GiB above the start"
    if "in_core_peak_gib" in row:
        text += f" (in core: {_fmt(row['in_core_peak_gib'])})"
    return text + f"; launches {row['launches']}; {row['device']}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m benchmark_spgemm_using_csr_tpu_torch.bench",
        description="C = A @ A GFlops over the suite, one card, each point "
                    "checked against scipy; one JSON headline on stdout.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the card must be there) or cpu")
    p.add_argument("--results", default=DEFAULT_RESULTS,
                   help="JSON-lines file the points' rows are appended to")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (--device cpu runs on the host)")
    budget_s = float(os.environ.get("BENCH_BUDGET_S") or 0.0)
    only = [x for x in os.environ.get("BENCH_ONLY", "").split(",") if x]
    try:
        harness = Harness(device=device, results=args.results, only=only,
                          budget_s=budget_s)
    except ValueError as e:
        raise SystemExit(f"BENCH_ONLY: {e}")
    emitted = []

    def emit(partial: bool) -> None:
        if emitted:
            return
        emitted.append(True)
        # a raw write: a signal may arrive while print holds stdout's lock
        os.write(1, (json.dumps(harness.headline(partial)) + "\n").encode())

    def on_signal(signum, frame):
        emit(partial=True)
        os._exit(128 + signum)

    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)
    before = {s: signal.signal(s, on_signal) for s in sigs}
    if budget_s:
        signal.alarm(int(max(60.0, budget_s - 45.0)))
    try:
        harness.run()
    except BaseException:
        emit(partial=True)
        raise
    finally:
        signal.alarm(0)
        for s, handler in before.items():
            signal.signal(s, handler)
    sys.stdout.flush()
    emit(partial=False)
    return 1 if harness.failed else 0


if __name__ == "__main__":
    sys.exit(main())
