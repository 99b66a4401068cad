"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one line (or a few):

1. require ``torch.cuda.is_available()``;
2. the card's name and power limit, and its max SM clock (nvidia-smi);
3. build the hand-written kernels K1 (``tile_sort_merge``), K2
   (``bin_sort_compress``), K3 (``dia_spgemm_fused``), K4
   (``dia_to_csr``), K5 (``symbolic_count``) and K6 (``rowlocal_esc``) from
   ``benchmark_spgemm_using_csr_tpu_torch/csrc`` with nvcc for sm_90a, one
   nvcc process each, all at once; then the registers and local memory
   (spills) of every instantiation, as cuobjdump reads them (K3's must
   have none);
4. K1 against its plain PyTorch version on the card, on er_medium's own
   packed tiles (the production shape) and on synthetic edge-case tiles at
   every width of its launch switch (128..2048): keys, positions and counts
   equal, values within rtol/atol 1e-6, and whether they are bit-equal;
   kernel, plain version and ``torch.sort`` of the same keys (a sort-only
   yardstick) timed with CUDA events on er_medium's tiles over batches of
   10 calls (the kernel also one call per window), beside the byte bound
   and the sort network's floor;
5. K2 the same way, on every tile the tiled and binned paths hand it
   (mc2depi_524k's and poisson2d_256's tiles, each bin of powerlaw_medium),
   each checked and timed, and on synthetic edge-case tiles at every width
   of its launch switch (2..2048, a ragged last block), float32 and
   float64;
6. K3 against its plain version, bit for bit, on synthetic cases (poisson,
   asymmetric banded A.B, ragged n, rectangular, an empty operand,
   float64, span 4096, 99 diagonals on 100 columns) and on the planes of
   every suite member the dispatcher sends to dia (float32; mc2depi_524k,
   stencil27_32 and pdb_8k also float64), and on a 300-diagonal float64
   band that the plan sends to K3's direct mode. On each: K3's launch plan
   and the blocks of it an SM holds at once (the occupancy query), the
   wrapper's host time a call, K3 timed in batches of 10 calls and one
   call alone (CUDA events, the L2 cache flushed by a 128 MB write before
   each sample) and by the profiler (its own device time), against the
   gather form that ``dia_spgemm(fused=False)`` runs (its plain version;
   fewer samples where it makes thousands of launches) and the byte
   bound. consph_83k, whose B span passes the reference's 4096, runs K3
   with ``bj`` widened to its span, as ``dia_spgemm`` does; then K4
   (``dia_to_csr``) on the C planes K3 makes of each of those matrices
   (three also in float64): bit-equal to its plain version, the
   sort-based conversion, pruned and not; timed in batches of 10 and
   alone (CUDA events, L2 flushed), by the profiler (its three kernels)
   and beside its byte bound and the sort-based conversion; on
   mc2depi_524k the whole ``dia_spgemm(A, A).to_csr(prune=True)``, one
   call at a time, with K4 and with the sort-based one; then K5
   (``symbolic.nnz_rows``) against its plain version ``nnz_exact``, row
   for row, on the CPU tests' synthetic cases and on the benchmark's three
   matrices at full size (circuit_262k, fem_81k, poisson2d_724,
   unpermuted): timed in batches of 10 and alone (CUDA events, L2
   flushed), by the profiler (its three kernels), beside its byte bound,
   the plain version and scipy's pattern product on the host; the grouped
   and tilepack plans counted by K5 against those scipy's count builds on
   the CPU, field for field (``python3 chip_smoke.py k5`` runs phases 1-3
   and this one alone); then K6 (``ops/rowlocal.rowlocal_esc``: K5's count,
   the scan and K6) at fem_81k's full size and on circuit_262k's rows that
   fit it (its hub rows keep its whole product on the stream): bit-equal to
   its plain version run on the card, timed in batches of 10 and alone
   (CUDA events, L2 flushed) and by the profiler (K6 and K5 apart), beside
   its byte bound and the plain version; then ``spgemm_chunked`` on the
   route eager and as a graph replay (bit-equal to eager), beside the
   stream's eager call on the same operands (``python3 chip_smoke.py k6``
   runs phases 1-3 and this one alone); then K7 (``ops/pair_stats``, the
   dispatcher's statistics) against its plain version, every integer, on
   the benchmark's circuit_262k, webbase_1m and poisson2d_724 at full
   size: timed (CUDA events, L2 flushed; the profiler's device time of
   each kernel, the fill apart) beside its byte bound, the whole pricing
   on the host clock (K7, its read back and the seven estimates) beside
   the plain version's on CPU tensors; the pick on every suite matrix
   through K7 (``python3 chip_smoke.py k7`` runs phases 1-3, this one and
   that pick alone);
7. the dispatcher's pick on every suite matrix (which it sends to dia);
   the main path, ``spgemm(A, A, method="auto")``, on er_medium,
   powerlaw_medium, circuit_64k, scircuit_256k, mc2depi_524k,
   poisson2d_256, stencil27_32 and pdb_8k at full size: the dispatcher's
   pick and its host time, the kernels'
   launch counts, the result against scipy at the CLI's float32
   tolerances, the host time of the plan (for dia: CSR -> DIA planes), and
   the median time and GFlops (2 * products / t) of the numeric phase
   (plan, or DIA planes, built beforehand) and of the whole call;
8. ``spgemm(A, A, method="tiled")`` on poisson2d_256 and mc2depi_524k, and
   ``spgemm_binned_host`` on powerlaw_medium (whose rows over 512 products
   take the ESC tail): verified, K2 launched, the numeric median timed;
9. the paths without a kernel of their own, at full suite size, seed 0:
   ``spgemm(A, A, method="auto")`` on dense_rows_2k (the dispatcher's bsr)
   and dense_rows_8k (dense); the out-of-core ``spgemm_batched(A, A)`` on
   dense_rows_8k at the default 64M-product stream budget (its per-block
   method and block count); ``method="hash"`` and ``method="fused"`` on
   powerlaw_medium (fused must launch K2); dense_rows_2k in float64 through
   bsr and dense against x64 scipy at rtol/atol 1e-12; SpMV, SpMM (64
   columns), SpAdd (A + A^T) and SpTRSV on mc2depi_524k; the BhSparse
   lifecycle on er_medium. Each: verified against scipy, the host time of
   its plan, the numeric median with the plan built, the whole call, and
   ``torch.cuda.max_memory_allocated()`` since the path started, absolute
   and above the start (nothing cleared between paths: the host mirror
   of ``sparse/csr.host_view`` holds its tensors weakly); then the
   CLI's ``--op spmv|spmm|spadd|sptrsv`` on mc2depi_524k, each in a
   subprocess, each verified (sptrsv: its level and step counts);
10. the AMG / ILU0 solver path, seed 0, float32, each line beside the
   card's name and power limit: on poisson2d_256 (the reference bench's
   rap_poisson2d_256 cell, P from ``aggregation_prolongator``) R·A·P by the
   chained ``galerkin_product`` (two ``spgemm(auto)``, the dispatcher's
   picks printed), by ``make_triple_plan`` + ``spgemm_triple`` and by
   ``make_aggrap_plan`` + ``rap_aggregation``, each against scipy with its
   host plan, numeric median and whole call; on mc2depi_524k
   ``build_hierarchy`` with and without smoothing (level sizes, setup split
   into aggregation, smoothing and R·A·P), ``numeric_refresh`` with A's
   values times 1.5 through the triple plan (smoothed P) and through
   aggrap (unsmoothed P), every level against scipy, ``solve`` (its
   residual history, the true residual in float64 on the host, the
   V-cycle's median), ILU0 (plan, sweeps, residual on A's pattern) and
   Jacobi-applied ILU0-PCG against plain CG; exact-ILU0 PCG on
   poisson2d_256. Each with its peak device memory and the K1-K4
   launches of its run;
11. the CLI, ``python -m benchmark_spgemm_using_csr_tpu_torch
   suite:er_medium --json --runs 3 --roofline`` (its shares must lie in
   (0, 1]) and ``suite:mc2depi_524k --dtype bfloat16``, in subprocesses;
12. ``spgemm(A, A, method="auto")`` in bfloat16 on er_medium (tilepack,
   K1), powerlaw_medium (chunked), circuit_64k (grouped), mc2depi_524k
   (dia, K3) and dense_rows_2k (bsr) at full size: the pick must be the
   reference's, each verified at rtol 2e-2 / atol 1e-2 against scipy's
   float32 product of the rounded values, numeric median, whole call and
   peak memory;
13. one ``utils/profiling.trace`` of ``spgemm(auto)`` (after two warm
   calls: er_medium's tilepack replays its graph) on er_medium and on
   mc2depi_524k (Chrome traces under ``_scratch/traces/``): device
   time by kernel name and the device's busy share of the window;
   ``tile_sort_merge`` and ``dia_spgemm`` must show device time;
14. the roofline of every path timed in phases 7-10 and 12
   (``utils/roofline``, the card's data-sheet row): each time's ``_bound``
   share and plan-aware ``_total`` share with the resource that bounds
   it, beside the card's name and power limit; fails if any share
   exceeds 1.0;
15. the distributed schedules (``parallel/``): NCCL at world size
   ``torch.cuda.device_count()`` (at most 4; in this process at 1, where
   the ring's shifts onto the rank itself are copies and the all-to-all
   and the gather run through NCCL), its world size and backend printed;
   ``dist_spgemm(A, A)`` with the replicated, ring and halo schedules on
   scircuit_256k and powerlaw_medium at full size, each verified against
   scipy at the CLI's tolerance, with the local kernel the facade picked,
   the host plan, the numeric median (CUDA events, 2 warmups, 5 runs), the
   whole call with its plan, the peak device memory above the start and
   the bytes each rank sends, read from the plan, beside the single-chip
   ``spgemm(auto)`` numeric median; ``dist_spadd(A, A^T)`` on mc2depi_524k
   beside the single-chip ``spadd_planned``; the group torn down; then the
   CLI's ``suite:powerlaw_medium --mesh 1 --schedule halo`` (verified, as
   ``dist/halox1``) and ``--mesh`` one past the cards, which must exit
   non-zero. No kernel of K1-K4 lies on these paths;
16. the suite harness (``benchmark_spgemm_using_csr_tpu_torch/bench.py``)
   in process, 3 timed runs a point, on the 12 suite points no earlier
   phase drives end to end (``BENCH_POINTS``), the rectangular pair and
   the float64 mini-suite: each point's line (method, numeric median and
   spread, whole call, peak, roofline shares, launches), each verified
   against scipy; fails if any point fails;
17. the large-scale demo (``scripts/demo_large``, its entry point in a
   subprocess) at its default size, the reference's record: C = A·A on
   the 77M-nnz scale-free matrix out of core (1.39B products, nnz(C)
   1.39B, C returned as a host scipy CSR), its lines (the plan's method
   and blocks, plan host time, first call, second call's device time,
   device peak, host peak RSS, the counts beside the record's) and both
   checks of C, the 512 sampled rows against scipy and the whole C
   through a vector; fails if the run exits non-zero;
18. the acceptance driver (``scripts/acceptance``, its entry point in a
   subprocess) at its full sizes on the card: the five BASELINE configs,
   config 5 on 8 gloo ranks on the CPU and over NCCL at world size
   ``torch.cuda.device_count()``, each against scipy; fails if any config
   fails.

19. the planned numeric phases as CUDA graphs (``ops/graphs``), run
   before phase 16: er_medium (tilepack, K1), powerlaw_medium (chunked),
   circuit_64k and scircuit_256k (grouped), er_small in float64 (grouped)
   and mc2depi_524k's lower and upper SpTRSV, at full size. Each: the
   eager body run once under ``torch.cuda.set_sync_debug_mode("error")``
   (a host read raises) and once more (do two eager calls agree bit for
   bit?), its device busy share by the profiler, the eager median and the
   public call's median (CUDA events, median of 5 after 2 warm-ups, as
   ``bench.py`` times them: warm-up 1 eager, warm-up 2 captures) with
   their spreads and peaks, the capture time, graph count and pool, the
   launches one replay adds, whether the replay is bit-equal to the eager
   call (it must be where two eager calls are), the result against scipy,
   and what the profiler sees of a replay. Then: two calls in a row return
   distinct storage; new values on the same structure replay the same
   graph and give the new product; the out-of-core grouped path on
   circuit_64k in 3+ blocks makes one capture. Then one row, as above,
   for each planned body of the solver path, bsr and the K2 paths
   (``NEW_GRAPH_PATHS``, full size): mc2depi_524k's numeric refresh (A x
   1.5) on phase 10's unsmoothed (9 coarse levels: 9 graphs) and
   smoothed hierarchies, poisson2d_256's triple product and aggregation
   R·A·P, mc2depi_524k's A + A^T, dense_rows_2k's bsr in float32 and on
   bfloat16 operands, banded_16k's in float64, mc2depi_524k's tiled (K2),
   powerlaw_medium's binned (a graph a bin and one for the tail's ESC)
   and fused (K2), and poisson2d_256's 10 ILU0 sweeps, each row also
   with the bytes a replay copies in and clones out beside the bodies'
   own least traffic (inputs read once, outputs written once); the eager
   call there is the public call under ``graphs.eager()``. Last, the
   unsmoothed refresh interleaved with the four ESC paths, four rounds:
   13 captures in round 2, none after. Phase 10 (its coarse LU takes ~57
   GiB) runs beside the graphs phases 7-9 left cached, and prints them
   and their shared pool before and after.

No kernel of K1-K4 lies on the paths of phases 17 and 18 (the
out-of-core blocks run chunked or grouped; K5 counts a grouped plan's
nnz(C) where the blocks' own count is not given). The kernel bounds of phases 4-6 come from ``utils/roofline`` too. The
launch counts of phases 7-10, 12 and 16 are set to 0 just before each path
is driven through its entry point and read just after; the kernels line and
the must-launch checks read those counts alone. The comparisons of phases
4-6 and the timing runs of phases 7-10 do not count.
Any failure raises and the exit code is not 0. The line before the last
is one JSON object on the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SENTINEL = 1 << 30
# dispatcher picks of the reference package for these matrices
EXPECTED = {
    "er_medium": "tilepack",
    "powerlaw_medium": "chunked",
    "circuit_64k": "grouped",
    "scircuit_256k": "grouped",
    "mc2depi_524k": "dia",  # each dia product through K3 on the card
    "poisson2d_256": "dia",
    "stencil27_32": "dia",  # 27 diagonals, 729 terms
    "pdb_8k": "dia",  # 99 diagonals, 9801 terms
    "dense_rows_2k": "bsr",  # phase 9
    "dense_rows_8k": "dense",  # phase 9
}
MATMUL_PICKS = ("dense_rows_2k", "dense_rows_8k")  # driven in phase 9
# main-path matrices whose run must launch the named kernel
MUST_LAUNCH = {"er_medium": "tile_sort_merge",
               "mc2depi_524k": "dia_spgemm_fused",
               "stencil27_32": "dia_spgemm_fused",
               "pdb_8k": "dia_spgemm_fused"}
# the suite members the dispatcher sends to dia
DIA_MATRICES = ("poisson2d_64", "poisson2d_256", "banded_16k", "stencil27_32",
                "mc2depi_524k", "fem_17k", "fem_32k", "pdb_8k", "fem_46k",
                "consph_83k")
F64_MATRICES = ("mc2depi_524k", "stencil27_32", "pdb_8k")  # K3 timed in f64
K3_SPAN = 4096  # the reference's block bj; dia_spgemm widens it past this
DIRECT_BAND, DIRECT_N = 300, 16384  # float64: K3's plan takes the direct mode
F32_TOL = dict(rtol=1e-4, atol=1e-5)  # the CLI's float32 verify tolerances
F64_TOL = dict(rtol=1e-12, atol=1e-12)  # float64 against x64 scipy
K1_TOL = dict(rtol=1e-6, atol=1e-6)
K2_TOL = K1_TOL  # the same addition tree as the plain version
K1_WIDTHS = (128, 256, 512, 1024, 2048)  # tile_sort_merge.cu's launch switch
K2_WIDTHS = tuple(1 << i for i in range(1, 12))  # bin_sort_compress.cu's
K3_TOL = dict(rtol=1e-6, atol=1e-6)  # bit-equal by design (no FMA)
SMS, LANES_PER_SM = 132, 128  # H100 SXM: 4 schedulers x 32 lanes per SM
PKG = "benchmark_spgemm_using_csr_tpu_torch"
# the reference package's dispatcher picks in bfloat16 (its CPU run;
# tests/test_torch_bf16.py holds the port's picks to them)
EXPECTED_BF16 = {"er_medium": "tilepack", "powerlaw_medium": "chunked",
                 "circuit_64k": "grouped", "mc2depi_524k": "dia",
                 "dense_rows_2k": "bsr"}
PROFILED = {"er_medium": "tile_sort_merge", "mc2depi_524k": "dia_spgemm"}
# the card's data-sheet row (utils/roofline.chip_spec), set by main()
CHIP = None
# roofline entries of the timed paths of phases 7-10 and the bfloat16
# phase: (label, plan-aware stage models or None, _bound, seconds)
ROOF = []


def phase(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, flush=None, batch: int = 1) -> float:
    """Median milliseconds of fn() over reps samples, CUDA events, after a
    warmup run. A sample is ``batch`` calls back to back, divided by
    ``batch``: with batch > 1 the host work of each call overlaps the
    previous call's kernels, with batch 1 it lies inside the window.
    ``flush``, a large tensor, is overwritten before every sample, so that
    fn finds its inputs outside the L2 cache."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound(model):
    """(bound_ms, bound_by) of a ``utils/roofline`` stage model on the
    card: the larger of its bytes over the HBM rate and its operations
    over their type's rate."""
    return model.sol_time_s(CHIP) * 1e3, model.bound_by(CHIP)


def suite_csr(port, name: str):
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators

    return port.CSR.from_scipy(generators.SUITE[name](), device="cuda")


# ---- K1 --------------------------------------------------------------------


def k1_inputs(rng, r: int, w: int, wlr: int, cbits: int):
    """Packed tiles with the cases K1 must get right: heavy duplicates,
    all-sentinel tiles, a single live lane, and a live last lane."""
    key = rng.integers(0, wlr << cbits, size=(r, w)).astype(np.int32)
    dup = rng.random(r) < 0.25  # heavy duplicates: few distinct keys
    key[dup] = rng.integers(0, 4, size=(int(dup.sum()), w)).astype(np.int32)
    key[rng.random((r, w)) < 0.3] = SENTINEL
    key[0] = SENTINEL  # all-sentinel tile
    key[1] = SENTINEL
    key[1, w // 3] = 5  # single live lane
    key[2, :] = SENTINEL
    key[2, -1] = (wlr - 1) << cbits  # live lane sorting last
    val = rng.standard_normal((r, w)).astype(np.float32)
    val[dup] = np.round(val[dup])  # equal (key, val) pairs too
    return key, val


def compare_tiles(name, got, want, tol, what: str) -> float:
    """A K1/K2 result against its plain version: keys, pos and counts
    equal, values within tol (the line says whether they are bit-equal).
    Returns the max abs value difference."""
    torch.cuda.synchronize()
    for i, part in ((0, "keys"), (2, "pos"), (3, "counts")):
        if not torch.equal(got[i], want[i]):
            bad = int((got[i] != want[i]).sum())
            raise AssertionError(f"{name} {part} differ on {what}: {bad}")
    torch.testing.assert_close(got[1], want[1], **tol)
    err = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
    phase(f"{name} on {what}: keys/pos/counts equal, values bit-equal "
          f"{torch.equal(got[1], want[1])}, max |val diff| {err:.3g}")
    return err


def time_tiles(name, what, fn, plain, keys, model, sm_hz) -> dict:
    """The kernel, its plain version and ``torch.sort`` of the same (r, W)
    keys with indices (a sort-only yardstick, not the kernel's function)
    timed on one input in batches of 10 calls, the kernel also alone (one
    call per window, the wrapper's host work included), beside the byte
    bound and the sort network's floor: its r * W/2 * L(L+1)/2
    compare-exchanges (L = log2 W) at one per lane and clock on every SM."""
    ms = cuda_ms(fn, batch=10)
    alone_ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, batch=10)
    sort_ms = cuda_ms(lambda: torch.sort(keys, dim=1), batch=10)
    bound_ms, bound_by = bound(model)
    nbytes = model.bytes_moved
    r, w = keys.shape
    lw = w.bit_length() - 1
    cmpx = r * (w // 2) * lw * (lw + 1) // 2
    floor_ms = cmpx / (SMS * LANES_PER_SM * sm_hz) * 1e3
    phase(f"{name} on {what}: kernel {ms:.4f} ms ({alone_ms:.4f} alone), "
          f"plain {plain_ms:.4f} ms, torch.sort of the keys {sort_ms:.4f} ms "
          f"(CUDA events, median of 10 batches of 10); bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{CHIP.name} data sheet; the kernel at {bound_ms / ms:.1%} of it); network floor "
          f"{floor_ms * 1e3:.1f} us ({cmpx / 1e6:.0f} M compare-exchanges)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k1(kernels, rng) -> float:
    """K1 vs plain on synthetic edge-case tiles at every width of its launch
    switch, with a ragged last block, and at the largest wlr; returns the
    max abs value difference."""
    worst = 0.0
    for w, wlr, cbits in [(w, 16, 10) for w in K1_WIDTHS] + [(128, 1024, 6)]:
        r = (1 << 22) // w + 3
        key_np, val_np = k1_inputs(rng, r, w, wlr, cbits)
        key = torch.from_numpy(key_np).cuda()
        val = torch.from_numpy(val_np).cuda()
        kw = dict(sentinel=SENTINEL, wlr=wlr, cbits=cbits)
        err = compare_tiles("K1", kernels.tile_sort_merge(key, val, **kw),
                            kernels.tile_sort_merge_plain(key, val, **kw),
                            K1_TOL, f"synthetic W={w} r={r} wlr={wlr}")
        worst = max(worst, err)
    return worst


def time_k1(port, kernels, sm_hz) -> dict:
    """K1 against its plain version on er_medium's own packed tiles, the
    production shape, then timed on them."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.tilepack import pack_tiles

    a = suite_csr(port, "er_medium")
    sched = port.make_tilepack_plan(a, a)
    key, val = pack_tiles(a, a, sched)
    kw = dict(sentinel=SENTINEL, wlr=sched.plan.wlr_eff, cbits=sched.plan.cbits)
    r, w = key.shape
    what = f"er_medium's tiles {(r, w)} wlr={kw['wlr']}"
    fn = functools.partial(kernels.tile_sort_merge, key, val, **kw)
    plain = functools.partial(kernels.tile_sort_merge_plain, key, val, **kw)
    err = compare_tiles("K1", fn(), plain(), K1_TOL, what)
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        tile_sort_merge_model,
    )

    model = tile_sort_merge_model(r, w, kw["wlr"])
    return dict(time_tiles("K1", what, fn, plain, key, model, sm_hz),
                max_abs_err=err)


# ---- K2 --------------------------------------------------------------------


def k2_inputs(rng, r: int, w: int, n: int):
    """Gathered product rows with the cases K2 must get right: heavy
    duplicates, all-sentinel rows, a single live lane, a live lane stored
    last, full rows without a sentinel."""
    col = rng.integers(0, n, size=(r, w)).astype(np.int32)
    dup = rng.random(r) < 0.25
    col[dup] = rng.integers(0, 3, size=(int(dup.sum()), w)).astype(np.int32)
    col[rng.random((r, w)) < 0.3] = n
    col[0] = n  # all-sentinel row
    col[1] = n
    col[1, w // 3] = n - 1  # single live lane
    col[2, :] = n
    col[2, -1] = 0  # live lane stored last, sorting first
    col[3] = rng.integers(0, n, size=w)  # no sentinel
    val = rng.standard_normal((r, w)).astype(np.float32)
    val[dup] = np.round(val[dup])
    return col, val


def check_k2(kernels, rng) -> float:
    """K2 vs plain on synthetic edge-case tiles at every width of its launch
    switch, with a ragged last block; returns the max abs value
    difference."""
    worst = 0.0
    cases = [(w, dtype) for dtype in (np.float32, np.float64)
             for w in K2_WIDTHS]
    for w, dtype in cases:
        r = (1 << 21) // w + 3
        n = 3 * w
        col_np, val_np = k2_inputs(rng, r, w, n)
        col = torch.from_numpy(col_np).cuda()
        val = torch.from_numpy(val_np.astype(dtype)).cuda()
        err = compare_tiles(
            "K2", kernels.bin_sort_compress(col, val, n_sentinel=n),
            kernels.bin_sort_compress_plain(col, val, n_sentinel=n),
            K2_TOL, f"synthetic W={w} r={r} {np.dtype(dtype).name}")
        worst = max(worst, err)
    return worst


def k2_path_tiles(port):
    """Every tile the tiled and binned paths of phase 8 hand K2, as (what,
    col, val, n): mc2depi_524k's tiled tile (the kernels line's), then
    poisson2d_256's, then each bin of powerlaw_medium."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.binned import (
        _bin_products,
        make_plan,
    )
    from benchmark_spgemm_using_csr_tpu_torch.ops.tiled import expand_rows

    for name in ("mc2depi_524k", "poisson2d_256"):
        a = suite_csr(port, name)
        col, val = expand_rows(a, a, port.make_tiled_plan(a, a))
        yield f"{name}'s tile {tuple(col.shape)}", col, val, a.n
    a = suite_csr(port, "powerlaw_medium")
    nnz_ct = port.nnz_upper_bound(a, a).long()
    prodstart = torch.cumsum(nnz_ct, 0) - nnz_ct
    bins, _ = make_plan(nnz_ct.cpu().numpy())
    for w, rows in bins.items():
        rows_dev = torch.from_numpy(rows).cuda().long()
        col, val = _bin_products(a, a, rows_dev, nnz_ct, prodstart, w)
        yield (f"powerlaw_medium's bin {tuple(col.shape)}", col,
               val.contiguous(), a.n)


def time_k2(port, kernels, sm_hz) -> dict:
    """K2 against its plain version on every path tile, each then timed.
    Returns mc2depi_524k's numbers with the worst error of all."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        bin_sort_compress_model,
    )

    first, worst = None, 0.0
    for what, col, val, n in k2_path_tiles(port):
        fn = functools.partial(kernels.bin_sort_compress, col, val,
                               n_sentinel=n)
        plain = functools.partial(kernels.bin_sort_compress_plain, col, val,
                                  n_sentinel=n)
        worst = max(worst, compare_tiles("K2", fn(), plain(), K2_TOL, what))
        r, w = col.shape
        model = bin_sort_compress_model(r, w, val.element_size())
        numbers = time_tiles("K2", what, fn, plain, col, model, sm_hz)
        first = first or numbers
    return dict(first, max_abs_err=worst)


def res_usage(build, name: str):
    """(function, registers, local bytes) per kernel of ``lib<name>.so``,
    as ``cuobjdump -res-usage`` reads them."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    lib = os.path.join(build.BUILD_DIR, f"lib{name}.so")
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    usage, fn = [], ""
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        fn = m.group(1) if m else fn
        m = re.search(r"REG:(\d+) .*LOCAL:(\d+)", line)
        if m:
            usage.append((fn, int(m.group(1)), int(m.group(2))))
    return usage


def resource_usage(build) -> None:
    """Registers and local memory (where spills would go) per thread of
    every kernel instantiation, as cuobjdump reads them from the built
    libraries; K3 (whose dynamic shared memory per block each launch plan
    sets, printed with its timing) and K4's count and fill kernels must
    use no local memory."""
    for name in ("tile_sort_merge", "bin_sort_compress"):
        usage = []
        for fn, reg, loc in res_usage(build, name):
            w = re.search(r"kernelI([fd]?)Li(\d+)E", fn)
            if w:
                usage.append((w.group(1), int(w.group(2)), reg, loc))
        phase(f"csrc/{name}.cu registers (local bytes) per thread: " + ", ".join(
            f"{'double ' if t == 'd' else ''}W={w}: {reg} ({loc})"
            for t, w, reg, loc in sorted(usage)))
    usage = sorted((k3_instance(fn), reg, loc)
                   for fn, reg, loc in res_usage(build, "dia_spgemm_fused")
                   if k3_instance(fn))
    phase("csrc/dia_spgemm_fused.cu registers (local bytes) per thread: "
          + ", ".join(f"{what}: {reg} ({loc})" for what, reg, loc in usage))
    if len(usage) != 18 or any(loc for *_, loc in usage):
        raise AssertionError(f"K3 instantiations: {usage}")
    k4 = re.compile(r"dia_to_csr_(count|fill)I([fd])Lb([01])E")
    usage = sorted((m.group(1) + (" double" if m.group(2) == "d" else "")
                    + (" pruned" if m.group(3) == "1" else ""), reg, loc)
                   for fn, reg, loc in res_usage(build, "dia_to_csr")
                   for m in [k4.search(fn)] if m)
    phase("csrc/dia_to_csr.cu registers (local bytes) per thread: "
          + ", ".join(f"{what}: {reg} ({loc})" for what, reg, loc in usage))
    if len(usage) != 8 or any(loc for *_, loc in usage):
        raise AssertionError(f"K4 instantiations: {usage}")
    k5 = re.compile(r"symbolic_count_(rows|medium|long)(ILb([01])E)?")
    usage = sorted((m.group(1) + (" shared map" if m.group(3) == "1" else
                                  " global map" if m.group(3) else ""),
                    reg, loc)
                   for fn, reg, loc in res_usage(build, "symbolic_count")
                   for m in [k5.search(fn)] if m)
    phase("csrc/symbolic_count.cu registers (local bytes) per thread: "
          + ", ".join(f"{what}: {reg} ({loc})" for what, reg, loc in usage))
    if len(usage) != 4 or any(loc for *_, loc in usage):
        raise AssertionError(f"K5 kernels: {usage}")
    k6 = re.compile(r"rowlocal_esc_kernelI([fd])E")
    usage = sorted(("double" if m.group(1) == "d" else "float", reg, loc)
                   for fn, reg, loc in res_usage(build, "rowlocal_esc")
                   for m in [k6.search(fn)] if m)
    phase("csrc/rowlocal_esc.cu registers (local bytes) per thread: "
          + ", ".join(f"{what}: {reg} ({loc})" for what, reg, loc in usage))
    if len(usage) != 2 or any(loc for *_, loc in usage):
        raise AssertionError(f"K6 kernels: {usage}")
    usage = sorted((kernel, reg, loc)
                   for fn, reg, loc in res_usage(build, "pair_stats")
                   for kernel in K7_KERNELS if kernel in fn)
    phase("csrc/pair_stats.cu registers (local bytes) per thread: "
          + ", ".join(f"{what}: {reg} ({loc})" for what, reg, loc in usage))


def k3_instance(fn: str) -> str:
    """'staged float V=4 16 warps' for a K3 kernel's mangled name, else
    ''."""
    m = re.search(r"dia_spgemm_kernel_(\w+?)I([fd])Li(\d+)E(?:Li(\d+)E)?",
                  fn)
    if not m:
        return ""
    return (f"{m.group(1)} {'double' if m.group(2) == 'd' else 'float'} "
            f"V={m.group(3)} {m.group(4) or 8} warps")


def k3_blocks_per_sm(lib, plan, itemsize: int) -> int:
    """The blocks of ``plan``'s launch shape one SM holds at once, as the
    occupancy query of ``lib`` (a build of csrc/dia_spgemm_fused.cu) gives
    it for the current device."""
    blocks = ctypes.c_int(0)
    err = lib.dia_spgemm_fused_occupancy(
        plan.smem, plan.lanes, plan.warps, int(plan.staged),
        int(itemsize == 8), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"K3 occupancy query failed: CUDA error {err}")
    return blocks.value


# ---- K3 --------------------------------------------------------------------


def compare_dia(dia_kernels, a, b, what: str, bj: int = K3_SPAN) -> float:
    """K3 against its plain version: offsets, type and every value bit
    for bit (both sum each plane's terms in one order without FMA).
    Returns the max abs difference (0)."""
    got = dia_kernels.dia_spgemm_fused(a, b, bj=bj)
    want = dia_kernels.dia_spgemm_fused_plain(a, b, bj=bj)
    torch.cuda.synchronize()
    if got.offsets != want.offsets or got.dtype != want.dtype:
        raise AssertionError(f"K3 offsets or type differ on {what}")
    torch.testing.assert_close(got.data, want.data, **K3_TOL)
    if not torch.equal(got.data, want.data):
        raise AssertionError(f"K3 is not bit-equal to its plain version on "
                             f"{what}")
    err = float((got.data - want.data).abs().max())
    phase(f"K3 on {what}: {len(got.offsets)} output planes, offsets equal, "
          f"bit-equal")
    return err


def check_k3(port, dia_kernels, rng) -> float:
    def planes(n, offsets, m=None, dtype=np.float32):
        data = rng.standard_normal((len(offsets), n)).astype(dtype)
        return port.DIA.from_numpy(data, sorted(offsets), (m or n, n),
                                   device="cuda")

    poisson = planes(1 << 16, (-256, -1, 0, 1, 256))
    cases = {
        "synthetic poisson n=65536": (poisson, poisson),
        "synthetic banded A.B (7 x 11 diagonals)": (
            planes(100000, range(-3, 4)), planes(100000, range(-5, 6))),
        "synthetic n = 3 * 4096 + 123": (planes(12411, (-40, 0, 9)),) * 2,
        "synthetic rectangular 4000 x 4300 x 5000": (
            planes(4300, (0, 3, 17), m=4000), planes(5000, (-3, 2), m=4300)),
        "synthetic empty operand": (
            poisson, port.DIA(torch.zeros((0, 1 << 16), device="cuda"), (),
                              (1 << 16, 1 << 16))),
        "synthetic float64": (planes(70000, (-9, 0, 4), dtype=np.float64),
                              planes(70000, (-2, 0, 11), dtype=np.float64)),
        "synthetic span 4096": (planes(20000, (-2048, -1, 0, 1, 2048)),) * 2,
        "synthetic 99 diagonals, n = 100": (
            planes(100, range(-49, 50)),) * 2,
    }
    return max(compare_dia(dia_kernels, a, b, what)
               for what, (a, b) in cases.items())


def profiler_ms(fn, kernel: str, flush, reps: int = 10, retry: bool = True):
    """Mean device time of the kernels whose name holds ``kernel``, over
    ``reps`` calls of fn each after the L2 flush, as torch.profiler's CUDA
    activity records them; None when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += evt.device_time_total
            count += evt.count
    if not count and retry:  # the profiler now and then records nothing
        return profiler_ms(fn, kernel, flush, reps, retry=False)
    return total / count / 1e3 if count else None


def k3_bound(dia_kernels, a, b):
    """(bound_ms, bound_by, nbytes, flops) of one product
    (``utils/roofline.dia_stage_models``): each plane read or written
    once; 2 flops per term slot whose A read falls inside the matrix, at
    the fp32 or fp64 rate."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        dia_flops,
        dia_stage_models,
    )

    off_c, _ = dia_kernels.plan_terms(a.offsets, b.offsets)
    model = dia_stage_models(
        a.ndiag, len(off_c), b.n, a.data.element_size(), nd_b=b.ndiag,
        flops=dia_flops(a.offsets, b.offsets, a.n, b.n))["plane_fma"]
    return (*bound(model), model.bytes_moved, model.flops)


def time_k3_once(dia_kernels, a, what: str, flush, gather_reps: int,
                 bj: int = K3_SPAN) -> dict:
    """K3 on A @ A against its plain version (the gather form that
    ``dia_spgemm(fused=False)`` runs), then timed: batches of 10 calls and
    one call alone (CUDA events, L2 flushed before each sample), the
    kernel's own device time (torch.profiler), and the gather form."""
    err = compare_dia(dia_kernels, a, a, what, bj)
    fn = functools.partial(dia_kernels.dia_spgemm_fused, a, a, bj=bj)
    plain = functools.partial(dia_kernels.dia_spgemm_fused_plain, a, a,
                              bj=bj)
    ms = cuda_ms(fn, flush=flush, batch=10)
    alone_ms = cuda_ms(fn, flush=flush)
    prof_ms = profiler_ms(fn, "dia_spgemm_kernel", flush)
    plain_ms = cuda_ms(plain, reps=gather_reps, flush=flush)
    host_ms = host_call_ms(fn)
    bound_ms, bound_by, nbytes, flops = k3_bound(dia_kernels, a, a)
    plan = dia_kernels.launch_plan(tuple(a.offsets), tuple(a.offsets), a.n,
                                   a.data.element_size())
    blocks = k3_blocks_per_sm(
        dia_kernels._build.cuda_library("dia_spgemm_fused"), plan,
        a.data.element_size())
    phase(f"K3's plan on {what}: {plan_text(plan)}, {blocks} blocks per SM "
          f"at once (occupancy query); the wrapper's host time "
          f"{host_ms * 1e3:.1f} us a call")
    prof = "not recorded" if prof_ms is None else f"{prof_ms:.4f} ms"
    share = "" if prof_ms is None else f"; the kernel at {bound_ms / prof_ms:.1%} of it"
    phase(f"K3 on {what}: kernel {ms:.4f} ms in batches of 10 "
          f"({alone_ms:.4f} alone), device time {prof} (profiler); plain "
          f"= gather form {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); CUDA "
          f"events, median of 10 (gather {gather_reps}), L2 flushed; "
          f"bound {bound_ms * 1e3:.1f} us by {bound_by} ({nbytes / 1e6:.1f} "
          f"MB, {flops / 1e6:.1f} MFLOP{share})")
    return dict(max_abs_err=err, ms=ms, alone_ms=alone_ms,
                profiler_ms=prof_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def host_call_ms(fn, calls: int = 50) -> float:
    """Host milliseconds per call of fn, enqueued back to back (the device
    keeps up or queues: no synchronize inside the window)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def plan_text(plan) -> str:
    mode = "staged" if plan.staged else "direct"
    return (f"{mode}, tile {plan.tile}, {plan.warps} warps x {plan.lanes} "
            f"slots a lane, {len(plan.groups)} plane groups, "
            f"{len(plan.groups) * plan.ntiles} blocks, {plan.smem} B of "
            f"dynamic shared memory per block")


def time_k3(port, dia_kernels, flush) -> dict:
    """K3 against the gather form on the planes of every suite member the
    dispatcher sends to dia (float32; the main path's three also float64),
    bit-equal and timed. A B span past the reference's 4096 is run with
    ``bj`` widened to the span, as ``dia_spgemm`` runs it. Returns {name:
    numbers} (float32)."""
    out = {}
    for name in DIA_MATRICES:
        a = port.DIA.from_csr(suite_csr(port, name), device="cuda")
        nd = a.ndiag
        span = max(0, max(a.offsets)) + max(0, -min(a.offsets))
        what = (f"{name}'s planes (n={a.n}, {nd} diagonals, {nd * nd} "
                f"terms, span {span})")
        reps = 3 if nd * nd > 1000 else 10
        if span > K3_SPAN:
            what += f", bj widened to {span}"
        out[name] = time_k3_once(dia_kernels, a, what, flush, reps,
                                 max(K3_SPAN, span))
        if name in F64_MATRICES:
            a64 = port.DIA(a.data.double(), a.offsets, a.shape)
            time_k3_once(dia_kernels, a64, what + " in float64", flush, reps)
            del a64
        del a
        torch.cuda.empty_cache()
    # the direct mode: a band too wide for shared memory at any tile
    band = range(-DIRECT_BAND // 2, DIRECT_BAND // 2)
    data = np.random.default_rng(1).standard_normal((DIRECT_BAND, DIRECT_N))
    a = port.DIA.from_numpy(data, band, (DIRECT_N, DIRECT_N), device="cuda")
    if dia_kernels.launch_plan(tuple(band), tuple(band), DIRECT_N, 8).staged:
        raise AssertionError("the direct-mode case is planned as staged")
    time_k3_once(dia_kernels, a, f"synthetic {DIRECT_BAND}-diagonal float64 "
                 f"band, n={DIRECT_N} (direct mode)", flush, 1)
    return out


# ---- K4 --------------------------------------------------------------------


def compare_k4(dia_convert, c, what: str) -> None:
    """K4 against its plain version (the sort-based conversion) on the
    planes ``c``, pruned and not: rowptr, colidx and vals over the whole
    capacity, bit for bit (it copies values)."""
    nnz = {}
    for prune in (True, False):
        got = dia_convert.dia_to_csr(c, prune)
        want = dia_convert.dia_to_csr_plain(c, prune)
        torch.cuda.synchronize()
        nnz[prune] = int(want.rowptr[-1])
        for x, y in ((got.rowptr, want.rowptr), (got.colidx, want.colidx),
                     (got.vals, want.vals)):
            if x.is_floating_point():
                view = torch.int64 if x.element_size() == 8 else torch.int32
                x, y = x.view(view), y.view(view)
            if not torch.equal(x, y):
                raise AssertionError(f"K4 is not bit-equal to its plain "
                                     f"version on {what} (prune={prune})")
    phase(f"K4 on {what}: nnz {nnz[True]} pruned of {nnz[False]} slots, "
          f"capacity {got.capacity}, bit-equal pruned and not")


def k4_bound(dia_convert, c):
    """(bound_ms, bound_by, nbytes) of one conversion: every plane read
    once, rowptr and the capacity's colidx and vals (the zero tail too)
    written once."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        StageModel,
    )

    item = c.data.element_size()
    cap = dia_convert.capacity(c.offsets, c.m, c.n)
    nbytes = c.ndiag * c.n * item + (c.m + 1) * 4 + cap * (4 + item)
    return (*bound(StageModel("dia_to_csr", float(nbytes), 0.0)), nbytes)


def time_k4(port, dia_convert, flush) -> dict:
    """K4 on the C planes (K3's output) of every suite member the
    dispatcher sends to dia (float32; the three of F64_MATRICES also
    float64), checked against its plain version; timed in batches of 10
    calls and one call alone (CUDA events, L2 flushed), by the profiler
    (the sum of its three kernels' device times), beside the byte bound
    and the plain version, the sort-based conversion the dia path ran
    before K4. On mc2depi_524k (poisson2d_724) also the whole
    ``dia_spgemm(A, A).to_csr(prune=True)`` a caller runs, one call at a
    time (``utils/timing.bench``), with K4 and with the sort-based
    conversion. Returns mc2depi_524k's numbers."""
    out = {}
    for name in DIA_MATRICES:
        a = port.DIA.from_csr(suite_csr(port, name), device="cuda")
        span = max(0, max(a.offsets)) + max(0, -min(a.offsets))
        c = port.dia_spgemm(a, a)
        kinds = [(c, "")]
        if name in F64_MATRICES:
            a64 = port.DIA(a.data.double(), a.offsets, a.shape)
            kinds.append((port.dia_spgemm(a64, a64), " in float64"))
        for planes, kind in kinds:
            what = (f"{name}'s C{kind} (n={planes.n}, {planes.ndiag} "
                    f"planes, span {span})")
            compare_k4(dia_convert, planes, what)
            fn = functools.partial(dia_convert.dia_to_csr, planes, True)
            plain = functools.partial(dia_convert.dia_to_csr_plain, planes,
                                      True)
            ms = cuda_ms(fn, flush=flush, batch=10)
            alone_ms = cuda_ms(fn, flush=flush)
            split = {k: profiler_ms(fn, f"dia_to_csr_{k}", flush)
                     for k in ("count", "scan", "fill")}
            prof_ms = (None if None in split.values()
                       else sum(split.values()))
            plain_ms = cuda_ms(plain, flush=flush)
            host_ms = host_call_ms(fn)
            bound_ms, bound_by, nbytes = k4_bound(dia_convert, planes)
            p = dia_convert.plan(tuple(planes.offsets), planes.m, planes.n,
                                 planes.data.element_size(), planes.device)
            prof = ("not recorded" if prof_ms is None else
                    f"{prof_ms:.4f} ms (count {split['count']:.4f}, scan "
                    f"{split['scan']:.4f}, fill {split['fill']:.4f}); the "
                    f"kernels at {bound_ms / prof_ms:.1%} of the bound")
            phase(f"K4 on {what}: {p.blocks} blocks, window {p.window} "
                  f"slots; kernel {ms:.4f} ms in batches of 10 "
                  f"({alone_ms:.4f} alone), device time {prof}; plain = "
                  f"the sort-based conversion {plain_ms:.4f} ms "
                  f"({plain_ms / ms:.1f}x); the wrapper's host time "
                  f"{host_ms * 1e3:.1f} us a call; bound {bound_ms * 1e3:.1f}"
                  f" us by {bound_by} ({nbytes / 1e6:.1f} MB); CUDA events, "
                  f"median of 10, L2 flushed")
            if not kind:
                out[name] = dict(ms=ms, alone_ms=alone_ms,
                                 profiler_ms=prof_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
        if name == "mc2depi_524k":
            from benchmark_spgemm_using_csr_tpu_torch.utils.timing import (
                bench,
            )

            calls = {
                "K4": lambda: port.dia_spgemm(a, a).to_csr(prune=True),
                "sort-based": lambda: dia_convert.dia_to_csr_plain(
                    port.dia_spgemm(a, a), True),
            }
            med = {}
            for k in (*calls, *reversed(calls)):  # two rounds, in turns
                med.setdefault(k, []).append(bench(
                    calls[k], device="cuda", warmup=20,
                    runs=300).median_s * 1e3)
            phase("mc2depi_524k: dia_spgemm(A, A).to_csr(prune=True), "
                  "median ms of 300 calls (CUDA events around each, "
                  "synchronised before it), two rounds: " + ", ".join(
                      f"{k} {ms[0]:.4f} / {ms[1]:.4f}"
                      for k, ms in med.items()))
            out[name]["call_ms"] = statistics.median(med["K4"])
            out[name]["sort_call_ms"] = statistics.median(med["sort-based"])
        del a, c, kinds
        torch.cuda.empty_cache()
    return out["mc2depi_524k"]


# ---- K5 --------------------------------------------------------------------

K5_MATRICES = ("circuit_262k", "fem_81k", "poisson2d_724")
K5_KERNELS = ("symbolic_count_rows", "symbolic_count_medium",
              "symbolic_count_long")


def bench_matrix(name: str):
    """The benchmark configuration's matrix (``spgemm_bench/configs``) at
    full size, unpermuted: (host scipy CSR, the configuration's counts)."""
    import scipy.sparse as sp

    from spgemm_bench import inputs

    with open(os.path.join("spgemm_bench", "configs", f"{name}.json")) as f:
        config = json.load(f)
    rowptr, colidx, vals, shape = inputs.matrix(config)
    return sp.csr_matrix((vals, colidx, rowptr), shape=shape), config["counts"]


def k5_bound(a, b, products: int):
    """(bound_ms, MB): K5's least traffic at the HBM rate, A's colidx, one
    B column a product, 8 bytes a row (rowptr and count): 4·nnz_a +
    4·products + 8·m."""
    nbytes = 4 * a.nnz + 4 * products + 8 * a.shape[0]
    return nbytes / CHIP.hbm_bytes_per_s * 1e3, nbytes / 1e6


def k5_cases():
    """``tests/test_torch_nnz_rows``: its cases and helpers."""
    sys.path.insert(0, "tests")
    import test_torch_nnz_rows

    return test_torch_nnz_rows


def check_k5_synthetic(port) -> None:
    """K5 against its plain version on the CPU tests' cases
    (``tests/test_torch_nnz_rows.PAIRS``: the three generators at their
    CPU size, rectangular, empty rows, every bin and its edges, a bitmap
    cleared by walk, a bitmap in device memory)."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import symbolic

    cases = k5_cases()
    for what, make in cases.PAIRS.items():
        sa, sb = make()
        got = symbolic.nnz_rows(*cases.csrs(sa, sb, "cuda")).cpu().numpy()
        want = cases.pattern_counts(sa, sb)
        if not np.array_equal(got, want):
            raise AssertionError(f"K5 on {what}: rows differ from the plain "
                                 f"version at {np.flatnonzero(got != want)[:8]}")
    phase(f"K5 on {len(cases.PAIRS)} synthetic cases "
          f"({', '.join(cases.PAIRS)}): every row equal to the plain version")


def time_k5(port, flush) -> dict:
    """K5 on the benchmark's three matrices at full size (A·A, unpermuted):
    row for row against its plain version and the configuration's nnz(C),
    timed (batches of 10 and alone, CUDA events, L2 flushed; the profiler's
    device time of its three kernels), beside its byte bound, the plain
    version and scipy's pattern product on the host; the grouped and
    tilepack plans it counts against scipy's on the CPU."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        grouped,
        symbolic,
        tilepack,
    )

    check_k5_synthetic(port)
    out = {}
    for name in K5_MATRICES:
        sa, cfg = bench_matrix(name)
        a = port.CSR.from_scipy(sa, device="cuda")
        ca = port.CSR.from_scipy(sa, device="cpu")
        products = int(cfg["products"])
        fn = functools.partial(symbolic.nnz_rows, a, a)
        rows = fn()
        cap = port.pad_bucket(products)
        plain = functools.partial(symbolic.nnz_exact, a, a, cap)
        if not torch.equal(rows, plain()):
            raise AssertionError(f"K5 on {name}: rows differ from nnz_exact")
        if int(rows.sum()) != int(cfg["nnz_c"]):
            raise AssertionError(f"K5 on {name}: nnz(C) {int(rows.sum())} "
                                 f"against the configuration's {cfg['nnz_c']}")
        ms = cuda_ms(fn, flush=flush, batch=10)
        alone_ms = cuda_ms(fn, flush=flush)
        parts = {k: profiler_ms(fn, k, flush) for k in K5_KERNELS}
        prof_ms = sum(v for v in parts.values() if v is not None)
        plain_ms = cuda_ms(plain, reps=3, flush=flush)
        t0 = time.perf_counter()
        pat = symbolic._pattern(ca)
        scipy_nnz = int((pat @ pat).nnz)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        if scipy_nnz != int(cfg["nnz_c"]):
            raise AssertionError(f"scipy's count on {name}: {scipy_nnz}")
        t0 = time.perf_counter()
        n_c = symbolic.exact_nnz_c(a, a)
        count_ms = (time.perf_counter() - t0) * 1e3
        bound_ms, mb = k5_bound(sa, sa, products)
        p = symbolic.nnz_upper_bound(a, a)
        bins = [int((p <= 32).sum()), int(((p > 32) & (p <= 1024)).sum()),
                int((p > 1024).sum())]
        plans = []
        for make in (grouped.make_grouped_plan, tilepack.make_tilepack_plan):
            want = make(ca, ca)
            before = symbolic.nnz_rows.launches
            got = make(a, a)
            if not k5_cases().same_schedule(got, want):
                raise AssertionError(f"{make.__name__} on {name}: the plan "
                                     f"K5 counts differs from scipy's")
            plans.append(f"{make.__name__.split('_')[1]} "
                         f"{'None' if want is None else want.plan.nnz_c} "
                         f"({symbolic.nnz_rows.launches - before} K5)")
        part_text = ", ".join(
            f"{k.split('_')[-1]} "
            + ("not recorded" if v is None else f"{v:.4f}")
            for k, v in parts.items())
        share = f"{bound_ms / prof_ms:.1%}" if prof_ms else "not measured"
        phase(f"K5 on {name} (m {sa.shape[0]}, nnz {sa.nnz}, products "
              f"{products}, nnz(C) {n_c}; rows by bin {bins}): kernel "
              f"{ms:.4f} ms in batches of 10 ({alone_ms:.4f} alone), device "
              f"time {prof_ms:.4f} ms (profiler: {part_text}); bound "
              f"{bound_ms * 1e3:.1f} us ({mb:.1f} MB, {share} of the device "
              f"time); plain nnz_exact {plain_ms:.4f} ms; exact_nnz_c "
              f"{count_ms:.2f} ms host (K5 + the 8-byte read); scipy's "
              f"pattern product {scipy_ms:.1f} ms host; plans equal to "
              f"scipy's: {', '.join(plans)}")
        out[name] = dict(ms=ms, alone_ms=alone_ms, profiler_ms=prof_ms,
                         bound_ms=bound_ms, plain_ms=plain_ms,
                         scipy_ms=scipy_ms, count_ms=count_ms)
        del a, ca, rows
        torch.cuda.empty_cache()
    return out


K6_MATRICES = ("fem_81k", "circuit_262k")


def k6_operands(port, name: str):
    """(A, B, plan, what) on the card for K6 at the configuration's full
    size: A·A where the chunked plan takes the row-local route (fem_81k);
    else (circuit_262k: 128 hub rows pass 8,192 products, so its whole
    product keeps the stream) the rows of A that fit K6, times A."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        chunked,
        rowlocal,
        stream,
    )

    sa, cfg = bench_matrix(name)
    a = port.CSR.from_scipy(sa, device="cuda")
    plan = chunked.make_chunked_plan(a, a)
    if plan.rowlocal is not None:
        return a, a, plan, f"A·A ({name})", cfg
    blen = np.diff(sa.indptr)
    cum = np.concatenate([[0], np.cumsum(blen[sa.indices])])
    products = cum[sa.indptr[1:]] - cum[sa.indptr[:-1]]
    pat = sa.astype(bool)
    c_rows = np.diff((pat @ pat).indptr)
    need = rowlocal.smem_bytes(products, c_rows, False)
    keep = np.flatnonzero((products <= rowlocal.MAX_PRODUCTS)
                          & (need <= rowlocal.BLOCK_SMEM_MAX))
    sub = port.CSR.from_scipy(sa[keep], device="cuda")
    plan = chunked.make_chunked_plan(sub, a)
    if plan.rowlocal is None:  # more shared memory than two blocks an SM
        plan = dataclasses.replace(
            plan, out_cap=stream.pad_gentle(int(c_rows[keep].sum())),
            rowlocal=rowlocal.make_launch(products[keep], c_rows[keep],
                                          torch.float32))
    what = (f"{name}: its whole product keeps the stream; its {keep.size} "
            f"rows (of {sa.shape[0]}) that fit K6 times A, one block an SM "
            f"(the plan keeps these on the stream too)")
    return sub, a, plan, what, None


def k6_bound(a, b, c_nnz: int, products: int, itemsize: int):
    """(bound_ms, GB): K6's least traffic at the HBM rate: A once (column
    and value), a B column and value a product, C once (column and value):
    (4 + s)·(nnz_a + products + nnz(C))."""
    nbytes = (4 + itemsize) * (int(a.rowptr[-1]) + products + c_nnz)
    return nbytes / CHIP.hbm_bytes_per_s * 1e3, nbytes / 1e9


def time_k6(port, flush) -> dict:
    """K6 (``ops/rowlocal.rowlocal_esc``: K5's count, the scan, K6) at the
    benchmark's full sizes (``k6_operands``): bit-equal to its plain version
    (run on the card), timed (batches of 10 and alone, CUDA events, L2
    flushed; the profiler's device time of K6 and of K5), beside its byte
    bound and the plain version; then the call as the cell makes it,
    ``spgemm_chunked`` on the route: eager, its graph's replays (each
    bit-equal to the eager call), and the stream's eager call on the same
    operands (``rowlocal=False``), its structure equal and its values
    within the float32 tolerance."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        chunked,
        graphs,
        rowlocal,
    )

    out = {}
    for name in K6_MATRICES:
        a, b, plan, what, cfg = k6_operands(port, name)
        route = plan.rowlocal
        fn = functools.partial(rowlocal.rowlocal_esc, a, b, route,
                               out_cap=plan.out_cap, max_run=plan.max_run)
        before = rowlocal.rowlocal_esc.launches
        got = fn()
        launched = rowlocal.rowlocal_esc.launches - before
        plain = functools.partial(rowlocal.rowlocal_esc_plain, a, b,
                                  out_cap=plan.out_cap, max_run=plan.max_run)
        want = plain()
        same = (torch.equal(got.rowptr, want.rowptr)
                and torch.equal(got.colidx, want.colidx)
                and torch.equal(got.vals.view(torch.int32),
                                want.vals.view(torch.int32)))
        if not same:
            raise AssertionError(f"K6 on {what}: not bit-equal to its plain "
                                 f"version")
        c_nnz = int(got.rowptr[-1])
        if cfg is not None and c_nnz != int(cfg["nnz_c"]):
            raise AssertionError(f"K6 on {name}: nnz(C) {c_nnz}")
        del want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = cuda_ms(fn, flush=flush, batch=10)
        alone_ms = cuda_ms(fn, flush=flush)
        k6_ms = profiler_ms(fn, "rowlocal_esc_kernel", flush)
        k5_parts = [profiler_ms(fn, k, flush) for k in K5_KERNELS]
        k5_ms = sum(v for v in k5_parts if v is not None)
        plain_ms = cuda_ms(plain, reps=3, flush=flush)
        torch.cuda.empty_cache()
        products = route.slots
        bound_ms, gb = k6_bound(a, b, c_nnz, products, 4)
        share = (f"{bound_ms / k6_ms:.1%} of K6's device time"
                 if k6_ms else "K6's device time not recorded")
        # the call as the cell makes it
        graphs.clear()
        call = functools.partial(chunked.spgemm_chunked, a, b, plan)
        with graphs.eager():
            eager = call()
        for _ in range(3):  # eager, capture, replay
            c = call()
            torch.cuda.synchronize()
            if not (torch.equal(c.colidx, eager.colidx)
                    and torch.equal(c.vals.view(torch.int32),
                                    eager.vals.view(torch.int32))):
                raise AssertionError(f"{what}: a call of the graph differs "
                                     f"from the eager call")
        replay_ms = cuda_ms(call, reps=10)
        with graphs.eager():
            eager_ms = cuda_ms(call, reps=5)
        graphs.clear()
        del c, got
        torch.cuda.empty_cache()
        splan = chunked.make_chunked_plan(a, b, rowlocal=False)
        stream = functools.partial(chunked.spgemm_chunked, a, b, splan)
        with graphs.eager():
            s_c = stream()
            torch.cuda.synchronize()
            if not (torch.equal(s_c.rowptr, eager.rowptr) and torch.equal(
                    s_c.colidx[:c_nnz], eager.colidx[:c_nnz])):
                raise AssertionError(f"{what}: the stream's structure "
                                     f"differs from K6's")
            err = (s_c.vals[:c_nnz] - eager.vals[:c_nnz]).abs().max().item()
            del s_c
            stream_ms = cuda_ms(stream, reps=3)
        del eager
        torch.cuda.empty_cache()
        phase(f"K6 on {what} (m {a.m}, products {products}, nnz(C) {c_nnz}; "
              f"{route.threads} threads and {route.smem} B of shared memory "
              f"a block, max_run {plan.max_run}): bit-equal to its plain "
              f"version; K5 + scan + K6 {ms:.4f} ms in batches of 10 "
              f"({alone_ms:.4f} alone), device time K6 "
              + ("not recorded" if k6_ms is None else f"{k6_ms:.4f}")
              + f" ms, K5 {k5_ms:.4f} ms (profiler, L2 flushed); {launched} "
              f"K6 launch a call; bound {bound_ms * 1e3:.1f} us ({gb:.3f} "
              f"GB, {share}); plain version {plain_ms:.2f} ms; a call's "
              f"device memory {peak_mib:.1f} MiB above its inputs; "
              f"spgemm_chunked on the route: eager {eager_ms:.3f} ms, graph "
              f"replay {replay_ms:.3f} ms (bit-equal to eager); the stream's "
              f"eager call {stream_ms:.3f} ms (same structure, values within "
              f"{err:.3g})")
        out[name] = dict(ms=ms, alone_ms=alone_ms, profiler_ms=k6_ms,
                         k5_ms=k5_ms, bound_ms=bound_ms, plain_ms=plain_ms,
                         replay_ms=replay_ms, eager_ms=eager_ms,
                         stream_ms=stream_ms)
        del a, b
        torch.cuda.empty_cache()
    return out


K7_MATRICES = ("circuit_262k", "webbase_1m", "poisson2d_724")
K7_KERNELS = ("rows_a", "rows_b", "count_bits", "list_offsets",
              "fill_segments", "fill_combine", "bsr_blocks")


def k7_bound(a, b):
    """(bound_ms, MB): K7's least traffic at the HBM rate: A's rowptr and
    colidx and B's rowptr and colidx, each once (B's row lengths, gathered
    an A entry at a time, are read from L2)."""
    nbytes = (4 * (a.shape[0] + 1) + 4 * a.nnz + 4 * (b.shape[0] + 1)
              + 4 * b.nnz)
    return nbytes / CHIP.hbm_bytes_per_s * 1e3, nbytes / 1e6


def host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn() over reps calls (after one)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_k7(port, flush) -> dict:
    """K7 against its plain version, integer for integer, on the
    benchmark's three one-shot matrices at full size (unpermuted); each
    timed on the card (its launches, no read back: CUDA events, L2
    flushed; the profiler's device time per kernel, the fill's two kernels
    apart), beside its byte bound; the whole pricing on the host clock:
    ``choose_method`` on new index buffers (K7, its read back, the seven
    estimates), and the plain version on CPU tensors."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch, pair_stats

    t0 = time.perf_counter()
    out = {}
    for name in K7_MATRICES:
        sa, cfg = bench_matrix(name)
        a = port.CSR.from_scipy(sa, device="cuda")
        ca = port.CSR.from_scipy(sa, device="cpu")
        got = pair_stats._launch(a, a)
        want = pair_stats.pair_stats_plain(ca, ca)
        if got != want:
            diff = {k: (v, vars(want)[k]) for k, v in vars(got).items()
                    if v != vars(want)[k]}
            raise AssertionError(f"K7 on {name}: {diff}")
        if got.products != int(cfg["products"]):
            raise AssertionError(f"K7 on {name}: products {got.products}")
        run = functools.partial(pair_stats.launch_k7, a, a)
        ms = cuda_ms(run, flush=flush)
        parts = {k: profiler_ms(run, k, flush) for k in K7_KERNELS}
        prof_ms = sum(v for v in parts.values() if v is not None)
        fill_ms = sum(parts[k] or 0.0 for k in ("fill_segments",
                                                "fill_combine"))

        def fresh():
            x = port.CSR(a.rowptr.clone(), a.colidx.clone(), a.vals, a.shape)
            return dispatch.choose_method(x, x)

        pick = fresh()
        choose_ms = host_ms(fresh)
        plain_ms = host_ms(lambda: pair_stats.pair_stats_plain(ca, ca), 3)
        if pick != dispatch.choose_method(ca, ca):
            raise AssertionError(f"{name}: the pick {pick} differs from the "
                                 f"plain version's")
        bound_ms, mb = k7_bound(sa, sa)
        share = f"{bound_ms / prof_ms:.1%}" if prof_ms else "not measured"
        part_text = ", ".join(
            f"{k} " + ("not recorded" if v is None else f"{v:.4f}")
            for k, v in parts.items())
        phase(f"K7 on {name} (m {sa.shape[0]}, nnz {sa.nnz}, products "
              f"{got.products}; tiles {got.tiles}, most rows a tile "
              f"{got.max_rows}, diagonals {got.nd_a}, bsr pairs "
              f"{got.bsr_pairs}): every integer equal to the plain version; "
              f"launches {ms:.4f} ms (CUDA events, L2 flushed), device time "
              f"{prof_ms:.4f} ms (profiler: {part_text}), of which the fill "
              f"{fill_ms:.4f} ms; bound {bound_ms * 1e3:.1f} us ({mb:.1f} MB, "
              f"{share} of the device time); choose_method on new buffers "
              f"{choose_ms:.2f} ms host (-> {pick}); plain version "
              f"{plain_ms:.1f} ms (host, CPU tensors)")
        out[name] = dict(ms=ms, profiler_ms=prof_ms, fill_ms=fill_ms,
                         bound_ms=bound_ms, choose_ms=choose_ms,
                         plain_ms=plain_ms)
        del a, ca
        torch.cuda.empty_cache()
    phase(f"[K7's phase: {time.perf_counter() - t0:.1f} s]")
    return out


# ---- the paths ---------------------------------------------------------------


def counts(kernels, dia_kernels) -> dict:
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        dia_convert,
        pair_stats,
        rowlocal,
        symbolic,
    )

    return {
        "tile_sort_merge": kernels.tile_sort_merge.launches,
        "bin_sort_compress": kernels.bin_sort_compress.launches,
        "dia_spgemm_fused": dia_kernels.dia_spgemm_fused.launches,
        "dia_to_csr": dia_convert.dia_to_csr.launches,
        "symbolic_count": symbolic.nnz_rows.launches,
        "rowlocal_esc": rowlocal.rowlocal_esc.launches,
        "pair_stats": pair_stats.pair_stats.launches,
    }


def reset_counts(kernels, dia_kernels) -> None:
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        dia_convert,
        pair_stats,
        rowlocal,
        symbolic,
    )

    kernels.tile_sort_merge.launches = 0
    kernels.bin_sort_compress.launches = 0
    dia_kernels.dia_spgemm_fused.launches = 0
    dia_convert.dia_to_csr.launches = 0
    symbolic.nnz_rows.launches = 0
    rowlocal.rowlocal_esc.launches = 0
    pair_stats.pair_stats.launches = 0


def numeric_fn(port, a, method):
    """The numeric phase of `method` with its plan (or DIA planes) built
    beforehand; ends in C's CSR."""
    if method == "tilepack":
        sched = port.make_tilepack_plan(a, a)
        return lambda: port.spgemm_tilepack(a, a, sched)
    if method == "grouped":
        sched = port.make_grouped_plan(a, a)
        return lambda: port.spgemm_grouped(a, a, sched)
    if method == "dia":
        ad = port.DIA.from_csr(a, device="cuda")
        return lambda: port.dia_spgemm(ad, ad).to_csr(prune=True)
    if method == "tiled":
        plan = port.make_tiled_plan(a, a)
        return lambda: port.spgemm_tiled(a, a, plan)
    if method == "bsr":
        a_b = port.BSR.from_scipy(a.to_scipy(), (8, 128), device="cuda")
        b_b = port.BSR.from_scipy(a.to_scipy(), (128, 128), device="cuda")
        plan = port.make_bsr_plan(a_b, b_b)
        return lambda: port.bsr_spgemm(a_b, b_b, plan)
    plan = port.make_chunked_plan(a, a)
    return lambda: port.spgemm_chunked(a, a, plan)


def roof(label, models, bound_model, seconds) -> None:
    """One timed path for the roofline phase: its plan-aware stage models
    (None: it has none), its ``_bound`` and a measured device time."""
    ROOF.append((label, models, bound_model, seconds))


def roof_spgemm(label, a, c, method, numeric_s, whole_s) -> None:
    """The roofline entries of one product's numeric median and whole call
    (``utils/roofline.spgemm_models``; dia's numeric phase receives DIA
    planes, its whole call CSR)."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        spgemm_models,
    )

    models, csr_bound = spgemm_models(a, a, c, method)
    num_bound = (spgemm_models(a, a, c, method, planes=True)[1]
                 if method == "dia" else csr_bound)
    roof(f"{label} numeric", models, num_bound, numeric_s)
    roof(f"{label} whole call", models, csr_bound, whole_s)


def report(port, a, name, method, run, launched, products, c, tol=F32_TOL,
           zeros=True):
    """Verify C against scipy, time the numeric phase (and the whole
    call), print one line; the two times go to the roofline phase."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    assert_csr_equal(c, spgemm_reference(a, a), check_explicit_zeros=zeros,
                     **tol)
    nnz_c = int(c.rowptr[-1])
    t0 = time.perf_counter()
    fn = numeric_fn(port, a, method)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    num = bench(fn, device="cuda", name=name, warmup=2, runs=5,
                flops=2 * products)
    line = (f"{name}: method={method} nnzA={int(a.rowptr[-1])} "
            f"products={products} nnzC={nnz_c} "
            f"launches={launched} verified; plan {plan_ms:.1f} ms (host "
            f"clock); numeric median "
            f"{num.median_s * 1e3:.3f} ms = {num.gflops_median:.3f} GFlops")
    e2e = bench(run, device="cuda", name=name, warmup=1, runs=3,
                flops=2 * products)
    phase(f"{line}; whole call median {e2e.median_s * 1e3:.3f} ms = "
          f"{e2e.gflops_median:.3f} GFlops")
    roof_spgemm(f"{name} {method}", a, c, method, num.median_s, e2e.median_s)


def drive(kernels, dia_kernels, run):
    """One path run with the launch counts set to 0 just before it and
    read just after. Returns (C, counts)."""
    reset_counts(kernels, dia_kernels)
    c = run()
    torch.cuda.synchronize()
    return c, counts(kernels, dia_kernels)


def suite_picks(port) -> None:
    """The dispatcher's pick on every suite matrix (CSR on the card), each
    printed beside its name; the EXPECTED ones must match."""
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators

    picks = {}
    for name in generators.SUITE:
        a = suite_csr(port, name)
        picks[name] = port.choose_method(a, a)
        del a
    phase("choose_method on the suite: " + ", ".join(
        f"{name} -> {method}" for name, method in picks.items()))
    dia = sorted(name for name, method in picks.items() if method == "dia")
    phase(f"choose_method sends {len(dia)} of {len(picks)} suite matrices "
          f"to dia: {', '.join(dia)}")
    wrong = {n: picks[n] for n, want in EXPECTED.items() if picks[n] != want}
    if wrong:
        raise AssertionError(f"dispatcher picks differ from {EXPECTED}: "
                             f"{wrong}")


def unique_vs_sort(a) -> None:
    """The bsr estimate's block keys through ``np.unique`` and through
    ``sorted_unique`` (one sort), on the host clock."""
    from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import (
        host_view,
        sorted_unique,
    )

    rowptr = host_view(a.rowptr).astype(np.int64)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(rowptr))
    keys = (rows // 8) * (a.n // 128) + host_view(a.colidx)[:len(rows)] // 128
    times = {}
    for fn in (np.unique, sorted_unique):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn(keys)
            best = min(best, time.perf_counter() - t0)
        times[fn.__name__] = (best * 1e3, got)
    if not np.array_equal(times["unique"][1], times["sorted_unique"][1]):
        raise AssertionError("sorted_unique differs from np.unique")
    phase(f"er_medium's {keys.size} block keys ({times['unique'][1].size} "
          f"distinct): np.unique {times['unique'][0]:.1f} ms, sorted_unique "
          f"{times['sorted_unique'][0]:.1f} ms (numpy {np.__version__}, "
          f"best of 3, host clock)")


def main_path(port, kernels, dia_kernels, launches) -> None:
    """``spgemm(A, A, method="auto")`` on the EXPECTED matrices."""
    for name, want_method in EXPECTED.items():
        if name in MATMUL_PICKS:
            continue
        a = suite_csr(port, name)
        products = port.spgemm_flops(a, a) // 2
        t0 = time.perf_counter()
        method = port.choose_method(a, a)
        phase(f"{name}: choose_method {(time.perf_counter() - t0) * 1e3:.1f} "
              f"ms (host clock; K7 and its read back)")
        if name == "er_medium":
            unique_vs_sort(a)
        if method != want_method:
            raise AssertionError(f"{name}: dispatcher chose {method}, "
                                 f"expected {want_method}")
        run = lambda: port.spgemm(a, a, method="auto")  # noqa: E731
        c, got = drive(kernels, dia_kernels, run)
        launches.update(got)
        report(port, a, name, method, run, got, products, c)
        need = MUST_LAUNCH.get(name)
        if need and got[need] <= 0:
            raise AssertionError(f"{name} did not launch {need}")
        del a, c
        torch.cuda.empty_cache()


def tiled_binned_paths(port, kernels, dia_kernels, launches) -> None:
    """``method="tiled"`` on poisson2d_256 and mc2depi_524k, and the
    binned path on powerlaw_medium."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.binned import make_plan

    for name in ("poisson2d_256", "mc2depi_524k"):
        a = suite_csr(port, name)
        products = port.spgemm_flops(a, a) // 2
        run = lambda: port.spgemm(a, a, method="tiled")  # noqa: E731
        c, got = drive(kernels, dia_kernels, run)
        launches.update(got)
        report(port, a, name, "tiled", run, got, products, c)
        if got["bin_sort_compress"] <= 0:
            raise AssertionError(f"tiled on {name} did not launch K2")
        del a, c
    a = suite_csr(port, "powerlaw_medium")
    products = port.spgemm_flops(a, a) // 2
    cap = port.pad_bucket(products)
    bins, tail = make_plan(port.nnz_upper_bound(a, a).cpu().numpy())
    run = lambda: port.spgemm_binned_host(  # noqa: E731
        a, a, prod_capacity=cap)
    c, got = drive(kernels, dia_kernels, run)
    launches.update(got)
    if got["bin_sort_compress"] <= 0:
        raise AssertionError("binned on powerlaw_medium did not launch K2")
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    assert_csr_equal(c, spgemm_reference(a, a), **F32_TOL)
    res = bench(run, device="cuda", name="binned", warmup=1, runs=3,
                flops=2 * products)
    phase(f"powerlaw_medium: binned bins "
          f"{ {w: int((r < a.m).sum()) for w, r in bins.items()} } tail rows "
          f"{tail.size} products={products} nnzC={int(c.rowptr[-1])} "
          f"launches={got} verified; median {res.median_s * 1e3:.3f} ms = "
          f"{res.gflops_median:.3f} GFlops")
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import (
        spgemm_models,
    )

    roof("powerlaw_medium binned (the whole call)",
         *spgemm_models(a, a, c, "binned"), res.median_s)


def bf16_paths(port, kernels, dia_kernels, launches) -> None:
    """``spgemm(A, A, method="auto")`` in bfloat16 at full size: the pick
    must be the reference's, each result verified against scipy's float32
    product of the rounded values (rtol 2e-2 / atol 1e-2, exact zeros
    pruned: bfloat16 sums cancel to exactly 0 often, and scipy drops them),
    with its numeric median, whole call and peak memory."""
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import TOLERANCES

    for name, want_method in EXPECTED_BF16.items():
        a = port.CSR.from_scipy(generators.SUITE[name](),
                                dtype=torch.bfloat16, device="cuda")
        method = port.choose_method(a, a)
        if method != want_method:
            raise AssertionError(f"{name} bfloat16: dispatcher chose "
                                 f"{method}, the reference {want_method}")
        products = port.spgemm_flops(a, a) // 2
        run = lambda: port.spgemm(a, a, method="auto")  # noqa: E731
        peak = Peak("cuda").start()
        c, got = drive(kernels, dia_kernels, run)
        peak = peak.text()
        launches.update(got)
        if c.vals.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: C in {c.vals.dtype}")
        report(port, a, f"{name} bfloat16", method, run, got, products, c,
               tol=TOLERANCES["bfloat16"], zeros=False)
        phase(f"  {name} bfloat16: {peak}")
        del a, c
        torch.cuda.empty_cache()


def profile_paths(port, logdir: str) -> None:
    """One ``utils/profiling.trace`` of ``spgemm(A, A, method="auto")`` (a
    warm call) on each PROFILED matrix: device time by kernel name and the
    device's busy share of the window (kernel and copy time over the host
    clock); the named kernel must show device time. Two warm calls come
    first, so a planned pick's traced call replays its graph rather than
    capturing it (``ops/graphs``)."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.profiling import (
        device_time_by_kernel,
        trace,
    )

    for name, kernel in PROFILED.items():
        a = suite_csr(port, name)
        port.spgemm(a, a, method="auto")
        port.spgemm(a, a, method="auto")
        for attempt in range(1, 4):  # the profiler now and then drops records
            with trace(os.path.join(logdir, name)) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                port.spgemm(a, a, method="auto")
                torch.cuda.synchronize()
                window = time.perf_counter() - t0
            by = device_time_by_kernel(prof)
            hit = sum(v for k, v in by.items() if kernel in k)
            if hit > 0:
                break
        busy = sum(by.values())
        top = ", ".join(f"{k[:60]} {v * 1e3:.3f}" for k, v in
                        list(by.items())[:8])
        phase(f"profile of spgemm(auto) on {name}: window {window * 1e3:.1f} "
              f"ms (host clock), device busy {busy * 1e3:.3f} ms = "
              f"{busy / window:.1%}; {len(by)} kernels, top (ms): {top}; "
              f"trace {logdir}/{name}/trace.json (attempt {attempt})")
        if hit <= 0:
            raise AssertionError(f"profile of {name}: no device time in "
                                 f"{kernel}")
        phase(f"  {kernel}* on {name}: {hit * 1e3:.4f} ms device time")
        del a


def roofline_phase(card: str) -> None:
    """Every timed path of phases 7-10 and the bfloat16 phase: its
    ``_bound`` share and its plan-aware ``_total`` share of the measured
    time, each with the resource that bounds it, beside the card; fails if
    any share exceeds 1.0 (the model would not be a lower bound)."""
    over = []
    for label, models, bound_model, secs in ROOF:
        t_b = bound_model.sol_time_s(CHIP)
        text = (f"_bound {t_b * 1e6:.2f} us = {t_b / secs:.2%} "
                f"({bound_model.bound_by(CHIP)})")
        shares = [t_b / secs]
        if models:
            t_bytes = sum(m.times_s(CHIP)[0] for m in models.values())
            t_ops = sum(m.times_s(CHIP)[1] for m in models.values())
            t_tot = sum(m.sol_time_s(CHIP) for m in models.values())
            shares.append(t_tot / secs)
            text += (f"; plan-aware _total {t_tot * 1e6:.2f} us = "
                     f"{t_tot / secs:.2%} "
                     f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        else:
            text += "; no plan-aware model"
        phase(f"roofline {label}: {secs * 1e3:.3f} ms measured; {text}; "
              f"{CHIP.name} data sheet [{card}]")
        if max(shares) > 1.0:
            over.append(label)
    if over:
        raise AssertionError(f"roofline shares above 1.0: {over}")


class Peak:
    """Peak device memory of one item: ``start()`` resets the peak;
    ``text()`` reads it, absolute and above the start. The host mirror of
    ``sparse/csr.host_view`` holds its tensors weakly, so no earlier path's
    freed buffers stay in the peak."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()
        return self

    def text(self) -> str:
        if not self.cuda:
            return "peak device memory not measured (no card)"
        peak = torch.cuda.max_memory_allocated()
        return (f"peak device memory {peak / 2 ** 30:.3f} GiB "
                f"({(peak - self.base) / 2 ** 30:.3f} above the start)")


def path_report(kernels, dia_kernels, launches, label, run, plan, check,
                flops: int, roofing=None) -> dict:
    """One path of phase 9: ``run`` (the whole call) driven once with the
    launch counts set to 0 just before and read just after, and the peak
    device memory since its start; ``check`` holds its result against
    scipy (and raises); ``plan()`` builds the host plan (timed on the host
    clock) and returns the numeric phase alone, whose median is timed
    (``plan`` None: the path has no separate plan, and the numeric phase
    is the call); then the whole call's. ``roofing(c)`` gives the path's
    (plan-aware models or None, _bound) for the roofline phase. Returns the
    launch counts."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    peak = Peak("cuda").start()
    c, got = drive(kernels, dia_kernels, run)
    peak = peak.text()
    launches.update(got)
    what = check(c)
    models = bound_model = None
    if roofing is not None:
        models, bound_model = roofing(c)
    del c
    if plan is None:
        plan_text = "no separate plan"
        num = whole = bench(run, device="cuda", name=label, warmup=1, runs=5,
                            flops=flops)
    else:
        t0 = time.perf_counter()
        numeric = plan()
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        plan_text = f"plan {plan_ms:.1f} ms (host clock)"
        num = bench(numeric, device="cuda", name=label, warmup=1, runs=5,
                    flops=flops)
        whole = bench(run, device="cuda", name=label, warmup=0, runs=1,
                      flops=flops)
    phase(f"{label}: {what}; launches={got}; {plan_text}; numeric median "
          f"{num.median_s * 1e3:.3f} ms; whole call median "
          f"{whole.median_s * 1e3:.3f} ms (of {whole.runs}); {peak}")
    if bound_model is not None:
        if plan is not None:
            roof(f"{label} numeric", models, bound_model, num.median_s)
        roof(f"{label} whole call", models, bound_model, whole.median_s)
    torch.cuda.empty_cache()
    return got


def csr_check(want, tol=F32_TOL, zeros=True):
    """A check for path_report: C against the scipy matrix ``want``."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
    )

    def check(c):
        assert_csr_equal(c, want, check_explicit_zeros=zeros, **tol)
        return (f"nnzC={want.nnz} verified against scipy (rtol "
                f"{tol['rtol']:g}, atol {tol['atol']:g})")
    return check


def library_paths(port, kernels, dia_kernels, launches) -> None:
    """Phase 9: the paths without a kernel of their own, plus fused (K2)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from benchmark_spgemm_using_csr_tpu_torch.native.levels import have_native
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        batched,
        bsr,
        dense,
        fused,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils import roofline as R
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        spgemm_reference,
    )

    report = functools.partial(path_report, kernels, dia_kernels, launches)

    def spgemm_roof(a, method):
        return lambda c: R.spgemm_models(a, a, c, method)

    def op_roof(nbytes, flops):
        """A one-stage op: its operands read once, its output written
        once; no plan-aware model."""
        return lambda _: (None, R.StageModel("_bound", float(nbytes),
                                             float(flops)))

    def bsr_plan(a):
        a_b = port.BSR.from_scipy(a.to_scipy(), (8, 128), device="cuda")
        b_b = port.BSR.from_scipy(a.to_scipy(), (128, 128), device="cuda")
        plan = bsr.make_bsr_plan(a_b, b_b)
        phase(f"  bsr plan: {plan.pairs_cap} block pairs (capacity), "
              f"{plan.out_blocks_cap} output blocks; the B gather holds "
              f"{plan.pairs_cap * 128 * 128 * a.vals.element_size() / 2 ** 30:.3f} GiB")
        return lambda: bsr.bsr_spgemm(a_b, b_b, plan)

    def dense_plan(a):
        plan = dense.make_dense_plan(a, a)
        phase(f"  dense plan: mode {plan.mode}, nnzC {plan.nnz_c} of "
              f"{plan.shape[0] * plan.shape[1]} slots")
        return lambda: dense.spgemm_dense(a, a, plan)

    # the dispatcher's matrix-multiply picks, through the main path's call
    for name, make in (("dense_rows_2k", bsr_plan),
                       ("dense_rows_8k", dense_plan)):
        a = suite_csr(port, name)
        products = port.spgemm_flops(a, a) // 2
        report(f"{name} auto -> {EXPECTED[name]} (products={products})",
               lambda: port.spgemm(a, a, method="auto"),
               functools.partial(make, a),
               csr_check(spgemm_reference(a, a), zeros=False),
               2 * products, spgemm_roof(a, EXPECTED[name]))
        del a

    # the reference bench's out-of-core point: dense_rows_8k, 64M budget
    a = suite_csr(port, "dense_rows_8k")
    products = port.spgemm_flops(a, a) // 2

    def fresh_batched():
        batched._plan_cache.clear()
        batched._total_cache.clear()
        return port.spgemm_batched(a, a)

    def batched_plan():
        batched._plan_cache.clear()  # the drive's run cached it
        plan = batched._cached_plan(a, a, 64 * 1024 * 1024, None)
        phase(f"  spgemm_batched plan: method {plan.method}, "
              f"{len(plan.blocks)} row blocks {plan.blocks}, modes "
              f"{[mode for mode, _ in plan.flat_c]}")
        return lambda: port.spgemm_batched(a, a)

    def batched_roof(c):
        plan = batched._cached_plan(a, a, 64 * 1024 * 1024, None)
        models, bound_model = R.spgemm_models(a, a, c, plan.method)
        if plan.method == "dense":
            models = R.batched_dense_stage_models(
                plan, a.n, a.n, int(a.rowptr[-1]))
        return models, bound_model

    report(f"dense_rows_8k spgemm_batched (out of core, products={products})",
           fresh_batched, batched_plan, csr_check(spgemm_reference(a, a)),
           2 * products, batched_roof)
    del a

    # hash and fused on powerlaw_medium
    a = suite_csr(port, "powerlaw_medium")
    products = port.spgemm_flops(a, a) // 2
    report("powerlaw_medium hash", lambda: port.spgemm(a, a, method="hash"),
           None, csr_check(spgemm_reference(a, a)), 2 * products,
           spgemm_roof(a, "hash"))

    def fused_plan():
        plan = fused.make_plan(a, a)
        phase(f"  fused plan: bins {plan.bin_rows} rows, tail "
              f"{plan.tail_rows} rows, out_cap {plan.out_cap}")
        return lambda: fused.spgemm_fused(a, a, plan)

    got = report("powerlaw_medium fused",
                 lambda: port.spgemm(a, a, method="fused"), fused_plan,
                 csr_check(spgemm_reference(a, a)), 2 * products,
                 spgemm_roof(a, "fused"))
    if got["bin_sort_compress"] <= 0:
        raise AssertionError("fused on powerlaw_medium did not launch K2")
    del a

    # float64 through bsr and dense
    s64 = generators.SUITE["dense_rows_2k"]().astype(np.float64)
    a = port.CSR.from_scipy(s64, device="cuda")
    products = port.spgemm_flops(a, a) // 2
    for method, make in (("bsr", bsr_plan), ("dense", dense_plan)):
        report(f"dense_rows_2k float64 {method}",
               lambda: port.spgemm(a, a, method=method),
               functools.partial(make, a),
               csr_check(spgemm_reference(a, a), F64_TOL,
                         zeros=method != "bsr"),
               2 * products, spgemm_roof(a, method))
    del a

    # SpMV, SpMM, SpAdd, SpTRSV on mc2depi_524k
    s = generators.SUITE["mc2depi_524k"]()
    a = port.CSR.from_scipy(s, device="cuda")
    nnz = s.nnz
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(s.shape[1]).astype(np.float32)
    xk_np = rng.standard_normal((s.shape[1], 64)).astype(np.float32)
    x, xk = torch.from_numpy(x_np).cuda(), torch.from_numpy(xk_np).cuda()

    def dense_check(want, tol):
        def check(y):
            np.testing.assert_allclose(y.cpu().numpy(), want, **tol)
            return f"verified against scipy (rtol {tol['rtol']:g})"
        return check

    a_bytes = R.csr_bytes(s.shape[0], nnz)
    for op, fn, arg, want, k in (("spmv", port.spmv, x, s @ x_np, 1),
                                 ("spmm", port.spmm, xk, s @ xk_np, 64)):
        report(f"mc2depi_524k {op}", lambda: fn(a, arg), None,
               dense_check(want, F32_TOL), 2 * nnz * k,
               op_roof(a_bytes + 4 * k * sum(s.shape), 2 * nnz * k))
    at = port.csr_transpose(a)

    def spadd_plan():
        plan = port.make_add_plan(a, at)
        return lambda: port.spadd_planned(a, at, plan)

    sum_sp = (s + s.T).tocsr()
    report("mc2depi_524k spadd (A + A^T)", lambda: port.spadd(a, at),
           spadd_plan,
           csr_check(sum_sp, dict(rtol=1e-3, atol=1e-3)), 2 * nnz,
           op_roof(2 * a_bytes + R.csr_bytes(s.shape[0], sum_sp.nnz),
                   2 * nnz - sum_sp.nnz))
    tri = sp.tril(s, format="csr")
    tri = (tri + sp.identity(s.shape[0], np.float32, format="csr")
           * (np.abs(tri).sum(axis=1).max() + 1.0)).tocsr()
    lower = port.CSR.from_scipy(tri, device="cuda")

    def trsv_plan():
        sched = port.make_trsv_plan(lower)
        phase(f"  sptrsv plan: {sched.plan.n_levels} levels, "
              f"{sched.plan.n_steps} steps of {sched.plan.chunk} rows, "
              f"level scheduler "
              f"{'C++' if have_native() else 'numpy fallback'}")
        return lambda: port.sptrsv_planned(lower, x, sched)

    report("mc2depi_524k sptrsv (lower)", lambda: port.sptrsv(lower, x),
           trsv_plan,
           dense_check(spsolve_triangular(tri, x_np, lower=True),
                       dict(rtol=1e-3, atol=1e-3)),
           2 * tri.nnz,
           op_roof(R.csr_bytes(s.shape[0], tri.nnz) + 8 * s.shape[0],
                   2 * tri.nnz))
    del a, at, lower

    # the BhSparse lifecycle on er_medium
    s = generators.SUITE["er_medium"]()
    want = (s @ s).tocsr()
    want.sort_indices()

    def lifecycle():
        h = port.BhSparse()
        h.init_platform()
        h.init_data(s.shape[0], s.shape[1], s.shape[1], s.indptr, s.indices,
                    s.data, s.indptr, s.indices, s.data)
        h.spgemm()
        out = h.get_c()
        h.free_mem()
        return out

    def bh_check(out):
        rowptr, colidx, vals = out
        np.testing.assert_array_equal(rowptr, want.indptr)
        np.testing.assert_array_equal(colidx, want.indices)
        np.testing.assert_allclose(vals, want.data, **F32_TOL)
        return f"get_c verified against scipy (nnzC={want.nnz})"

    products = int(np.diff(s.indptr)[s.indices].sum())
    report("er_medium BhSparse lifecycle", lifecycle, None, bh_check, 0,
           lambda _: (None, R.csr_product_bound(
               s.shape[0], s.shape[1], s.nnz, s.nnz, want.nnz, products)))


def cli_ops() -> None:
    """The CLI's other ops on mc2depi_524k, each in a subprocess."""
    for op in ("spmv", "spmm", "spadd", "sptrsv"):
        out = subprocess.run(
            [sys.executable, "-m", PKG, "suite:mc2depi_524k", "--op", op,
             "--json", "--runs", "3"],
            capture_output=True, text=True, timeout=600, check=True,
        )
        record = json.loads(out.stdout.strip().splitlines()[-1])
        if record.get("verified") is not True:
            raise AssertionError(f"CLI --op {op} not verified: {record}")
        extra = (f", {record['n_levels']} levels, {record['n_steps']} steps"
                 if op == "sptrsv" else "")
        phase(f"CLI --op {op} suite:mc2depi_524k: verified, mean "
              f"{record['mean_s'] * 1e3:.3f} ms, min "
              f"{record['min_s'] * 1e3:.3f} ms, {record['gflops']:.3f} "
              f"GFlops on {record['device']}{extra}")


def cli_run() -> None:
    """The CLI with ``--roofline`` on er_medium and in bfloat16 on
    mc2depi_524k, each in a subprocess, each verified."""
    for spec, extra in (("suite:er_medium", ["--roofline"]),
                        ("suite:mc2depi_524k", ["--dtype", "bfloat16"])):
        out = subprocess.run(
            [sys.executable, "-m", PKG, spec, "--json", "--runs", "3",
             *extra],
            capture_output=True, text=True, timeout=600, check=True,
        )
        record = json.loads(out.stdout.strip().splitlines()[-1])
        if record.get("verified") is not True:
            raise AssertionError(f"CLI run not verified: {record}")
        text = ""
        if "roofline" in record:
            rep = record["roofline"]
            for key in ("_total", "_bound"):
                if not 0 < rep[key]["sol_fraction"] <= 1.0:
                    raise AssertionError(f"CLI roofline {key}: {rep[key]}")
            text = (f"; --roofline ({record['roofline_method']}): _bound "
                    f"{rep['_bound']['sol_fraction']:.2%} "
                    f"({rep['_bound']['bound_by']}), _total "
                    f"{rep['_total']['sol_fraction']:.2%} of the mean whole "
                    f"call, {rep['_total']['chip']} data sheet")
        phase(f"CLI {spec} {' '.join(extra)}: {record['dtype']}, verified, "
              f"mean {record['mean_s'] * 1e3:.3f} ms, {record['gflops']:.3f} "
              f"GFlops on {record['device']}{text}")


# ---- phase 10: the AMG / ILU0 solver path ---------------------------------

RAP_MATRIX = "poisson2d_256"  # the reference bench's rap_poisson2d_256 cell
AMG_MATRIX = "mc2depi_524k"  # AMG setup, refreshes, solve; ILU0 and PCG
EXACT_MATRIX = "poisson2d_256"  # exact-ILU0 PCG (eager SpTRSV steps)
RAP_TOL = dict(rtol=1e-3, atol=1e-4)  # the reference bench's (bench.py:966)
ILU0_PATTERN_LIMIT = 2e-3  # max |(LU - A)_ij| on A's pattern, 10 sweeps
AMG_TRUE_RESIDUAL = 1e-3  # the reference's test_amg_vcycle_converges bound


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_s(fn, device):
    """(result, seconds) of fn() on the host clock, the device synchronized
    before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


class Recorder:
    """Wraps module functions for one ``with`` block: host seconds per
    function (device synchronized around each call) and the dispatcher's
    picks as (shape of A, shape of B, method)."""

    def __init__(self, device, targets):
        self.device = device
        self.targets = targets  # (module, function name) pairs
        self.seconds = collections.Counter()
        self.picks = []

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            out, secs = host_s(lambda: fn(*args, **kwargs), self.device)
            self.seconds[name] += secs
            if name == "choose_method":
                self.picks.append((args[0].shape, args[1].shape, out))
            return out
        return timed

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def solver_paths(port, kernels, dia_kernels, launches, card: str,
                 device="cuda"):
    """Phase 10: the AMG / ILU0 solver path at full size, seed 0, float32.
    Every result is verified; its host and device times and its peak
    device memory are printed beside the card's name. Returns the AMG
    matrix and its two hierarchies ({smooth: hierarchy}, the coarse LU
    dropped) for phase 19."""
    from benchmark_spgemm_using_csr_tpu_torch.models import amg, ilu0
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        aggrap,
        dispatch,
        reuse,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils import roofline as R
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    def say(msg):
        phase(f"{msg} [{card}]")

    def nbytes(*mats):
        return sum(R.csr_bytes(x.shape[0], x.nnz) for x in mats)

    def rap_bound(r_sp, a_sp, p_sp, nnz_c):
        """R·A·P's least work: R, A and P read once, C written once, the
        products of the cheaper association (scipy structures, host)."""
        ap, ra = a_sp @ p_sp, r_sp @ a_sp
        products = min(
            np.diff(p_sp.indptr)[a_sp.indices].sum()
            + np.diff(ap.indptr)[r_sp.indices].sum(),
            np.diff(a_sp.indptr)[r_sp.indices].sum()
            + np.diff(p_sp.indptr)[ra.indices].sum())
        return R.StageModel("_bound", float(nbytes(r_sp, a_sp, p_sp)
                                            + R.csr_bytes(r_sp.shape[0], nnz_c)),
                            2.0 * products)

    def total(bounds):
        return R.StageModel("_bound", sum(b.bytes_moved for b in bounds),
                            sum(b.flops for b in bounds))

    def level_bounds(h, a_first_sp):
        """The R·A·P bound of every coarse level of hierarchy h."""
        out, cur = [], a_first_sp
        for li in range(1, len(h.levels)):
            nxt = h.levels[li].a.to_scipy()
            out.append(rap_bound(h.levels[li].r.to_scipy(), cur,
                                 h.levels[li].p.to_scipy(), nxt.nnz))
            cur = nxt
        return out

    def median_ms(fn, name):
        return bench(fn, device=device, name=name, warmup=2,
                     runs=5).median_s * 1e3

    def driven(fn):
        """fn() with the K1-K4 counts set to 0 just before, read after."""
        reset_counts(kernels, dia_kernels)
        out = fn()
        sync(device)
        got = counts(kernels, dia_kernels)
        launches.update(got)
        return out, got

    def scipy_rap(r_sp, a_sp, p_sp):
        """R·(A·P) by scipy in float64."""
        f64 = [x.astype(np.float64) for x in (r_sp, a_sp, p_sp)]
        c = (f64[0] @ (f64[1] @ f64[2])).tocsr()
        c.sort_indices()
        return c

    # -- rap_poisson2d_256: three routes to R·A·P ---------------------------
    a_sp = generators.SUITE[RAP_MATRIX]()
    p_sp, agg_s = host_s(lambda: amg.aggregation_prolongator(a_sp), "cpu")
    p_sp = p_sp.astype(np.float32).tocsr()
    r_sp = p_sp.T.tocsr()
    a = port.CSR.from_scipy(a_sp, device=device)
    p = port.CSR.from_scipy(p_sp, device=device)
    r = port.CSR.from_scipy(r_sp, device=device)
    want = scipy_rap(r_sp, a_sp, p_sp)
    say(f"{RAP_MATRIX} R·A·P: A {a_sp.shape[0]} rows, {a_sp.nnz} entries; "
        f"P {p_sp.shape} from aggregation_prolongator in "
        f"{agg_s * 1e3:.1f} ms (host); R·A·P nnz {want.nnz}")

    def chained():
        return amg.galerkin_product(a, p, r)

    def triple_plan():
        return reuse.make_triple_plan(r, a, p)

    def agg_plan():
        return aggrap.make_aggrap_plan(r, a, p)

    routes = (
        ("chained galerkin_product (two spgemm(auto))", None, chained),
        ("make_triple_plan + spgemm_triple", triple_plan,
         lambda s: reuse.spgemm_triple(r, a, p, s)),
        ("make_aggrap_plan + rap_aggregation", agg_plan,
         lambda s: aggrap.rap_aggregation(a, s)),
    )
    rap_b = rap_bound(r_sp, a_sp, p_sp, want.nnz)
    for label, plan, numeric in routes:
        peak = Peak(device).start()
        with Recorder(device, [(dispatch, "choose_method")]) as rec:
            if plan is None:
                (c, got), whole_s = host_s(lambda: driven(chained), device)
                plan_text, num = "no separate plan", chained
            else:
                def whole():
                    return numeric(plan())
                (c, got), whole_s = host_s(lambda: driven(whole), device)
                sched, plan_s = host_s(plan, device)
                if sched is None:
                    raise AssertionError(f"{label}: the plan's gate refused "
                                         f"{RAP_MATRIX}")
                plan_text = f"host plan {plan_s * 1e3:.1f} ms"
                num = functools.partial(numeric, sched)
        peak = peak.text()
        assert_csr_equal(c, want, **RAP_TOL)
        picks = ", ".join(f"{sa}·{sb} -> {m}" for sa, sb, m in rec.picks)
        num_ms = median_ms(num, label)
        say(f"  {label}: verified against scipy (structure exact, rtol "
            f"{RAP_TOL['rtol']:g}, atol {RAP_TOL['atol']:g}); auto took "
            f"[{picks or 'none'}]; launches={got}; {plan_text}; numeric "
            f"median {num_ms:.3f} ms (5 after 2 "
            f"warmups); whole call {whole_s * 1e3:.1f} ms; {peak}")
        models = None
        if plan is None:  # the two products' plan-aware models
            ap = port.spgemm(a, p)
            first, _ = R.spgemm_models(a, p, ap, rec.picks[0][2])
            second, _ = R.spgemm_models(r, ap, c, rec.picks[1][2])
            models = {**{f"A·P {k}": v for k, v in first.items()},
                      **{f"R·(AP) {k}": v for k, v in second.items()}}
            del ap
        short = label.split(" (")[0]
        roof(f"{RAP_MATRIX} R·A·P {short} numeric", models, rap_b,
             num_ms / 1e3)
        roof(f"{RAP_MATRIX} R·A·P {short} whole call", models, rap_b,
             whole_s)
    del a, p, r, c

    # -- AMG on mc2depi_524k -------------------------------------------------
    a_sp = generators.SUITE[AMG_MATRIX]()
    targets = [(amg, "aggregation_prolongator"), (amg, "smooth_prolongator"),
               (amg, "galerkin_product"), (dispatch, "choose_method")]
    hier = {}
    for smooth in (True, False):
        peak = Peak(device).start()
        with Recorder(device, targets) as rec:
            (h, got), setup_s = host_s(lambda: driven(
                lambda: amg.build_hierarchy(a_sp, smooth=smooth,
                                            device=device)), device)
        peak = peak.text()
        hier[smooth] = h
        sizes = [(lv.a.m, int(lv.a.rowptr[-1])) for lv in h.levels]
        picks = sorted(collections.Counter(m for _, _, m in rec.picks).items())
        sec = rec.seconds
        say(f"{AMG_MATRIX} build_hierarchy(smooth={smooth}): "
            f"{len(h.levels)} levels (rows, nnz) {sizes}; setup "
            f"{setup_s * 1e3:.1f} ms = aggregation "
            f"{sec['aggregation_prolongator'] * 1e3:.1f} (host) + smoothing "
            f"{sec['smooth_prolongator'] * 1e3:.1f} + R·A·P "
            f"{sec['galerkin_product'] * 1e3:.1f} + the rest; auto took "
            f"{picks}; launches={got}; {peak}")
        if len(h.levels) < 2 or any(
                sizes[i + 1][0] >= sizes[i][0] for i in range(len(sizes) - 1)):
            raise AssertionError(f"the hierarchy does not coarsen: {sizes}")
        roof(f"{AMG_MATRIX} build_hierarchy(smooth={smooth}) setup (device "
             f"bound: the levels' R·A·P)", None,
             total(level_bounds(h, a_sp)), setup_s)

    # numeric refresh: A's values times 1.5, each level against scipy. A
    # smoothed P takes the triple plan; an aggregation P takes aggrap where
    # the reference's gate admits the level (coarse key bits <= 32)
    a_new_sp = a_sp.copy()
    a_new_sp.data = (a_new_sp.data * np.float32(1.5)).astype(np.float32)
    for smooth in (True, False):
        h = hier[smooth]
        a_new = port.CSR.from_scipy(a_new_sp, device=device)
        peak = Peak(device).start()
        (h2, got), first_s = host_s(
            lambda: driven(lambda: amg.numeric_refresh(h, a_new)), device)
        peak = peak.text()
        kinds = [k for k, _ in h._triple_plans[1:]]
        bits = [max(int(lv.a.m - 1).bit_length(), 1) * 2
                for lv in h.levels[1:]]
        routes = (["triple"] * len(bits) if smooth else
                  ["agg" if b <= 32 else "triple" for b in bits])
        if kinds != routes or (not smooth and "agg" not in kinds):
            raise AssertionError(f"smooth={smooth}: refresh took {kinds}, "
                                 f"not {routes}")
        cur = a_new_sp
        for li in range(1, len(h.levels)):
            r_sp = h.levels[li].r.to_scipy()
            p_sp = h.levels[li].p.to_scipy()
            want = scipy_rap(r_sp, cur, p_sp)
            assert_csr_equal(h2.levels[li].a, want, **RAP_TOL)
            cur = want
        again = median_ms(lambda: amg.numeric_refresh(h, a_new),
                          f"refresh smooth={smooth}")
        roof(f"{AMG_MATRIX} numeric_refresh(smooth={smooth}) cached", None,
             total(level_bounds(h2, a_new_sp)), again / 1e3)
        say(f"{AMG_MATRIX} numeric_refresh(A x 1.5), smooth={smooth}: "
            f"routes per coarse level {kinds}; {len(h.levels) - 1} coarse "
            f"levels verified against scipy R·A·P (rtol {RAP_TOL['rtol']:g});"
            f" first call (plans built) {first_s * 1e3:.1f} ms; cached "
            f"median {again:.3f} ms; launches={got}; {peak}")
    del h2, a_new

    # solve: the V-cycle as the solver, b from the seed
    b = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    peak = Peak(device).start()
    ((x, hist), got), solve_s = host_s(lambda: driven(
        lambda: amg.solve(a_sp, b, tol=1e-4, max_iters=40, device=device)),
        device)
    peak = peak.text()
    a64 = a_sp.astype(np.float64)
    true_res = (np.linalg.norm(b - a64 @ x.astype(np.float64))
                / np.linalg.norm(b.astype(np.float64)))
    bt = torch.from_numpy(b).to(device)
    vc_ms = median_ms(lambda: amg.v_cycle(hier[True], bt), "v_cycle")
    levels = hier[True].levels
    n_c = levels[-1].a.m
    # every operator read once, and the coarsest level's dense LU factors
    # (n_c^2 floats, 2 n_c^2 flops in the two triangular solves)
    ops = [lv.a.to_scipy() for lv in levels] + [
        x.to_scipy() for lv in levels[1:] for x in (lv.r, lv.p)]
    roof(f"{AMG_MATRIX} v_cycle (smoothed hierarchy)", None,
         R.StageModel("_bound", float(nbytes(*ops) + 4 * n_c * n_c),
                      2.0 * (sum(x.nnz for x in ops) + n_c * n_c)),
         vc_ms / 1e3)
    say(f"{AMG_MATRIX} solve(b, tol 1e-4, max_iters 40): {len(hist)} "
        f"residuals {[f'{v:.3e}' for v in hist]}; true residual (float64, "
        f"host) {true_res:.3e}; whole solve {solve_s * 1e3:.1f} ms (setup "
        f"included); V-cycle median {vc_ms:.3f} ms (coarsest LU factored "
        f"beforehand); launches={got}; {peak}")
    if not hist[-1] < 1e-4 or not true_res < AMG_TRUE_RESIDUAL:
        raise AssertionError(f"AMG solve: history {hist[-1]:.3e}, true "
                             f"residual {true_res:.3e}")
    for h in hier.values():
        h.__dict__.pop("_coarse_lu", None)  # ~30 GiB
    amg_sp = a_sp

    # -- ILU0 on mc2depi_524k, and PCG against CG -----------------------------
    a = port.CSR.from_scipy(a_sp, device=device)
    plan, plan_s = host_s(lambda: ilu0.ilu0_plan(a_sp), device)
    peak = Peak(device).start()
    f, ilu_s = host_s(lambda: ilu0.ilu0(a, sweeps=10, plan=plan), device)
    peak = peak.text()
    res = ilu0.ilu0_residual_on_pattern(a, f)
    a_b = nbytes(a_sp)
    roof(f"{AMG_MATRIX} ilu0(sweeps=10) (A read, the factor written, once)",
         None, R.StageModel("_bound", 2.0 * a_b, 0.0), ilu_s)
    say(f"{AMG_MATRIX} ILU0: ilu0_plan {plan_s * 1e3:.1f} ms (host, max_deps "
        f"{plan.dep_l.shape[1]}); ilu0(sweeps=10) {ilu_s * 1e3:.1f} ms "
        f"(upload, sweeps, download); residual on A's pattern {res:.3e} "
        f"(limit {ILU0_PATTERN_LIMIT:g}); {peak}")
    if not res < ILU0_PATTERN_LIMIT:
        raise AssertionError(f"ILU0 residual on the pattern {res:.3e}")
    runs = {}
    for label, factor in (("CG", None), ("ILU0-PCG (jacobi)", f)):
        peak = Peak(device).start()
        (x, hist), secs = host_s(lambda: ilu0.pcg(
            a, bt, factor, tol=1e-5, max_iters=200, precond="jacobi"),
            device)
        peak = peak.text()
        true_res = (np.linalg.norm(b - a64 @ x.astype(np.float64))
                    / np.linalg.norm(b.astype(np.float64)))
        runs[label] = hist
        # an iteration reads A (and the factor, on A's pattern) once, and
        # four vectors
        roof(f"{AMG_MATRIX} {label} an iteration", None,
             R.StageModel("_bound", float(a_b * (1 if factor is None else 2)
                                          + 16 * a_sp.shape[0]),
                          2.0 * a_sp.nnz), secs / len(hist))
        say(f"{AMG_MATRIX} {label} (tol 1e-5, max_iters 200): {len(hist)} "
            f"iterations ({'converged' if hist[-1] < 1e-5 else 'not converged'}"
            f"), last residual {hist[-1]:.3e}, true residual (float64, host) "
            f"{true_res:.3e}; {secs * 1e3 / len(hist):.3f} ms an iteration; "
            f"{peak}")
    # iterations each run takes to the lowest residual both reach (the
    # tolerance when both converge)
    level = max(1e-5, runs["CG"][-1], runs["ILU0-PCG (jacobi)"][-1])
    steps = {k: next(i for i, v in enumerate(h) if v <= level)
             for k, h in runs.items()}
    say(f"{AMG_MATRIX} iterations to relative residual {level:.3e}: {steps}")
    if not steps["ILU0-PCG (jacobi)"] < steps["CG"]:
        raise AssertionError(f"ILU0-PCG took no fewer iterations: {steps}")
    del a, f, plan, bt

    # -- exact-ILU0 PCG on poisson2d_256 (level-scheduled SpTRSV) -----------
    a_sp = generators.SUITE[EXACT_MATRIX]()
    a = port.CSR.from_scipy(a_sp, device=device)
    f = ilu0.ilu0(a, sweeps=10)
    b = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    peak = Peak(device).start()
    (x, hist), secs = host_s(lambda: ilu0.pcg(
        a, torch.from_numpy(b).to(device), f, tol=1e-5, max_iters=200,
        precond="exact"), device)
    peak = peak.text()
    true_res = (np.linalg.norm(b - a_sp.astype(np.float64) @ x.astype(
        np.float64)) / np.linalg.norm(b.astype(np.float64)))
    roof(f"{EXACT_MATRIX} exact ILU0-PCG an iteration", None,
         R.StageModel("_bound", float(2 * nbytes(a_sp) + 16 * a_sp.shape[0]),
                      4.0 * a_sp.nnz), secs / len(hist))
    say(f"{EXACT_MATRIX} ILU0-PCG (exact, tol 1e-5, max_iters 200): "
        f"{len(hist)} iterations, last residual {hist[-1]:.3e}, true "
        f"residual (float64, host) {true_res:.3e}; "
        f"{secs * 1e3 / len(hist):.1f} ms an iteration (two SpTRSV solves "
        f"each, schedules built once); {peak}")
    if not hist[-1] < 1e-5 or not true_res < 1e-3:
        raise AssertionError(f"exact ILU0-PCG: {hist[-1]:.3e}, {true_res:.3e}")
    return amg_sp, hier


# ---- phase 15: the distributed schedules on the card ---------------------

DIST_MATRICES = ("scircuit_256k", "powerlaw_medium")
DIST_ADD_MATRIX = "mc2depi_524k"  # dist_spadd(A, A^T)
DIST_MAX_WORLD = 4


def dist_sent_bytes(plan, schedule: str, b_cap: int, rank: int,
                    dtype) -> int:
    """The bytes ``rank`` sends in one call, read from the plan: none for
    replicated; for the ring, H-1 prologue shifts and P/H - 1 hops of H
    blocks of b_cap (column, value) pairs, the value as float32 bits where
    it rides in them; for the halo, its row of the send sizes times a
    column and a value. (The gather of C comes on top.)"""
    if schedule == "replicated":
        return 0
    if schedule == "ring":
        packed = dtype in (torch.float32, torch.bfloat16, torch.float16)
        pair = 8 if packed else 4 + dtype.itemsize
        st = plan.statics
        hops = st.n_shards // st.hop - 1
        return (st.hop - 1 + hops * st.hop) * b_cap * pair
    return int(plan.send_sizes[rank].sum()) * (4 + dtype.itemsize)


def dist_rank(mesh, card: str) -> None:
    """Phase 15 on one rank (rank 0 prints): every schedule on the
    DIST_MATRICES and dist_spadd on DIST_ADD_MATRIX, at full size, each
    verified against scipy, beside the single-chip numeric median."""
    import benchmark_spgemm_using_csr_tpu_torch as port
    from benchmark_spgemm_using_csr_tpu_torch.parallel import dist
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    say = phase if mesh.rank == 0 else (lambda msg: None)
    dev = mesh.device
    say(f"phase 15: torch.distributed world size {mesh.size}, backend "
        f"{mesh.backend}, rank {mesh.rank} on {dev} [{card}]")
    for name in DIST_MATRICES:
        a = port.CSR.from_scipy(generators.SUITE[name](), device=dev)
        golden = spgemm_reference(a, a)
        products = port.spgemm_flops(a, a) // 2
        method = port.choose_method(a, a)
        one = bench(numeric_fn(port, a, method), device=dev, warmup=2,
                    runs=5)
        say(f"{name} single-chip spgemm(auto) -> {method}: numeric median "
            f"{one.median_s * 1e3:.3f} ms [{card}]")
        for schedule in ("replicated", "ring", "halo"):
            dist._PLAN_CACHE.clear()
            dist._SHARD_CACHE.clear()
            peak = Peak(dev).start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = dist.dist_plan(a, a, mesh.size, schedule)
            plan_ms = (time.perf_counter() - t0) * 1e3
            c = dist.dist_spgemm(a, a, mesh, schedule=schedule)
            torch.cuda.synchronize()
            whole_ms = (time.perf_counter() - t0) * 1e3
            peak_text = peak.text()
            assert_csr_equal(c, golden, **F32_TOL)
            num = bench(lambda: dist.dist_spgemm_local(a, a, mesh, plan,
                                                       schedule),
                        device=dev, warmup=2, runs=5, flops=2 * products)
            if schedule == "replicated":
                kernel = ("grouped" if isinstance(plan, dist.DistGroupedPlan)
                          else "chunked")
            elif schedule == "ring":
                kernel = (f"ring expansion k={plan.statics.k} hop="
                          f"{plan.statics.hop} + merge")
            else:
                kernel = "chunked against the halo"
            b_cap = dist.shard_rows_cached(a, mesh.size).cap
            sent = dist_sent_bytes(plan, schedule, b_cap, mesh.rank, a.dtype)
            say(f"{name} dist_spgemm {schedule} x{mesh.size}: local kernel "
                f"{kernel}; verified; host plan {plan_ms:.1f} ms; numeric "
                f"median {num.median_s * 1e3:.3f} ms = "
                f"{num.gflops_median:.3f} GFlops (single-chip "
                f"{one.median_s * 1e3:.3f} ms); whole call (plan built) "
                f"{whole_ms:.1f} ms; {peak_text}; rank {mesh.rank} sends "
                f"{sent} bytes a call [{card}]")
        del a, c, golden
    a = port.CSR.from_scipy(generators.SUITE[DIST_ADD_MATRIX](), device=dev)
    at = port.csr_transpose(a)
    sa = a.to_scipy()
    peak = Peak(dev).start()
    t0 = time.perf_counter()
    c = dist.dist_spadd(a, at, mesh)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    peak_text = peak.text()
    assert_csr_equal(c, (sa + sa.T).tocsr(), **F32_TOL)
    num = bench(lambda: dist.dist_spadd(a, at, mesh), device=dev, warmup=2,
                runs=5)
    add_plan = port.make_add_plan(a, at)
    one = bench(lambda: port.spadd_planned(a, at, add_plan), device=dev,
                warmup=2, runs=5)
    say(f"{DIST_ADD_MATRIX} dist_spadd(A, A^T) x{mesh.size}: verified; "
        f"first call {whole_ms:.1f} ms; median (shards cached, gather "
        f"included) {num.median_s * 1e3:.3f} ms (single-chip spadd_planned "
        f"{one.median_s * 1e3:.3f} ms); {peak_text}; no exchange [{card}]")


def dist_phase(card: str) -> None:
    """Phase 15: NCCL at world size torch.cuda.device_count() (at most
    DIST_MAX_WORLD): in this process at world size 1, else one spawned
    rank per card; the group is torn down before the phase returns. Then
    the CLI's --mesh on the card."""
    from benchmark_spgemm_using_csr_tpu_torch.parallel import bootstrap
    from benchmark_spgemm_using_csr_tpu_torch.parallel.launch import (
        free_port,
        spawn,
    )

    world = min(torch.cuda.device_count(), DIST_MAX_WORLD)
    if world == 1:
        bootstrap.init_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cuda")
        try:
            dist_rank(bootstrap.global_mesh(), card)
        finally:
            bootstrap.shutdown()
    else:
        spawn(dist_rank, world, card, device="cuda", timeout_s=900)
    if torch.distributed.is_initialized():
        raise AssertionError("phase 15 left a process group up")

    out = subprocess.run(
        [sys.executable, "-m", PKG, "suite:powerlaw_medium", "--mesh", "1",
         "--schedule", "halo", "--json", "--runs", "3"],
        capture_output=True, text=True, timeout=600, check=True,
    )
    record = json.loads(out.stdout.strip().splitlines()[-1])
    if record.get("verified") is not True or record["method"] != "dist/halox1":
        raise AssertionError(f"CLI --mesh 1 --schedule halo: {record}")
    phase(f"CLI suite:powerlaw_medium --mesh 1 --schedule halo: "
          f"{record['method']}, verified, mean {record['mean_s'] * 1e3:.3f} "
          f"ms on {record['device']} [{card}]")
    n_cards = torch.cuda.device_count()
    over = subprocess.run(
        [sys.executable, "-m", PKG, "suite:powerlaw_medium", "--mesh",
         str(n_cards + 1), "--json"],
        capture_output=True, text=True, timeout=300,
    )
    if over.returncode == 0:
        raise AssertionError(f"--mesh {n_cards + 1} on a {n_cards}-card host "
                             "exited 0")
    phase(f"CLI --mesh {n_cards + 1} on a {n_cards}-card host: exit "
          f"{over.returncode} ({over.stderr.strip().splitlines()[-1]})")


# ---- phase 16: the suite harness ------------------------------------------

# the suite points no earlier phase drives end to end, the pair, the f64 suite
BENCH_POINTS = ("banded_16k", "webbase_1m", "econ_206k", "fem_17k",
                "fem_32k", "fem_46k", "femirr_17k", "pattern_circuit_64k",
                "hubrows_32k", "road_1m", "smallworld_400k", "consph_83k",
                "rect_96k_24k_48k", "er_small_f64", "poisson2d_256_f64",
                "fem_17k_f64", "dense_rows_2k_f64", "scircuit_f64",
                "banded_16k_f64")
BENCH_RUNS = 3


def bench_phase(launches) -> None:
    """Phase 16: the harness's points of ``BENCH_POINTS``, in process; the
    launches of each point's verified run and whole call join the paths'
    counts. Fails if any point fails."""
    from benchmark_spgemm_using_csr_tpu_torch import bench

    t0 = time.perf_counter()
    harness = bench.Harness(
        device="cuda", runs=BENCH_RUNS, only=BENCH_POINTS, say=phase,
        results=os.path.join("_scratch", "bench", "results_torch.jsonl"))
    harness.run()
    for row in harness.rows:
        launches.update(row.get("launches", {}))
    phase(f"phase 16 headline ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(harness.headline())}")
    if harness.failed:
        raise AssertionError(f"harness points failed: {harness.failed}")


# ---- phase 19: the planned numeric phases as CUDA graphs -------------------

# (suite matrix, path, value type): each planned phase routed through
# ops/graphs, at full size
GRAPH_PATHS = (
    ("er_medium", "tilepack", torch.float32),
    ("powerlaw_medium", "chunked", torch.float32),
    ("circuit_64k", "grouped", torch.float32),
    ("scircuit_256k", "grouped", torch.float32),
    ("er_small", "grouped", torch.float64),
    ("mc2depi_524k", "sptrsv lower", torch.float32),
    ("mc2depi_524k", "sptrsv upper", torch.float32),
)


def result_tensors(x) -> list:
    """The tensors of a result: a tensor, a CSR or BSR, an AMG hierarchy's
    coarse operators, or a tuple of those."""
    if isinstance(x, torch.Tensor):
        return [x]
    if hasattr(x, "levels"):
        return [t for lv in x.levels[1:] for t in result_tensors(lv.a)]
    if hasattr(x, "blocks"):
        return [x.rowptr, x.colidx, x.blocks]
    if hasattr(x, "rowptr"):
        return [x.rowptr, x.colidx, x.vals]
    return [t for y in x for t in result_tensors(y)]


def same_bits(x, y) -> bool:
    """Two results (CSRs, BSRs, hierarchies or tensors) equal bit for
    bit."""
    xs, ys = result_tensors(x), result_tensors(y)
    return len(xs) == len(ys) and all(
        p.shape == q.shape and p.dtype == q.dtype and torch.equal(
            p.contiguous().view(torch.uint8), q.contiguous().view(torch.uint8))
        for p, q in zip(xs, ys))


def busy_share(fn, logdir: str):
    """(device busy s, host-clock window s, kernel names) of one fn() under
    ``utils/profiling.trace``."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.profiling import (
        device_time_by_kernel,
        trace,
    )

    for _ in range(3):  # the profiler now and then drops records
        with trace(logdir) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        by = device_time_by_kernel(prof)
        if by:
            break
    return sum(by.values()), window, len(by)


def graph_operands(port, name: str, path: str, dtype):
    """(public(), eager(), check(out) -> text, flops) of one GRAPH_PATHS
    entry: the public call (graphs from the second call) and the eager
    body with the same plan, both on the card."""
    import scipy.sparse as sp

    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        chunked,
        grouped,
        sptrsv,
        tilepack,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )

    s = generators.SUITE[name]()
    if path.startswith("sptrsv"):
        from scipy.sparse.linalg import spsolve_triangular

        lower = path.endswith("lower")
        part = sp.tril(s) if lower else sp.triu(s)
        tri = (part + sp.identity(s.shape[0], np.float32, format="csr")
               * (np.abs(part).sum(axis=1).max() + 1.0)).tocsr()
        t = port.CSR.from_scipy(tri, device="cuda")
        x_np = np.random.default_rng(0).standard_normal(
            s.shape[0]).astype(np.float32)
        x = torch.from_numpy(x_np).cuda()
        sched = port.make_trsv_plan(t, lower=lower)
        want = spsolve_triangular(tri, x_np, lower=lower)

        def check(out):
            np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-3,
                                       atol=1e-3)
            return (f"x verified against scipy's spsolve_triangular; "
                    f"{sched.plan.n_steps} steps, {sched.plan.n_levels} "
                    f"levels")

        return (lambda: port.sptrsv_planned(t, x, sched),
                lambda: sptrsv._solve(t, x, sched.stream, sched.diag_pos,
                                      sched.plan),
                check, 2 * tri.nnz)
    a = port.CSR.from_scipy(s, dtype=dtype, device="cuda")
    products = int(np.diff(s.indptr)[s.indices].sum())
    tol = F64_TOL if dtype == torch.float64 else F32_TOL
    want = spgemm_reference(a, a)

    def check(c):
        assert_csr_equal(c, want, **tol)
        return (f"nnzC={int(c.rowptr[-1])} verified against scipy (rtol "
                f"{tol['rtol']:g})")

    if path == "tilepack":
        sc = port.make_tilepack_plan(a, a)
        eager = lambda: tilepack._spgemm_tilepack(  # noqa: E731
            a, a, sc.slot0, sc.q, sc.first_rank, sc.plan)
        return (lambda: port.spgemm_tilepack(a, a, sc), eager, check,
                2 * products)
    if path == "grouped":
        sc = port.make_grouped_plan(a, a)
        eager = lambda: grouped._spgemm_grouped(  # noqa: E731
            a, a, sc.slot0, sc.first_rank, sc.sorted_off, sc.fill_end,
            sc.plan)
        return (lambda: port.spgemm_grouped(a, a, sc), eager, check,
                2 * products)
    plan = port.make_chunked_plan(a, a)
    return (lambda: port.spgemm_chunked(a, a, plan),
            lambda: chunked._spgemm_chunked(a, a, plan), check, 2 * products)


def ms_spread(res) -> str:
    spread = (max(res.times) - min(res.times)) / res.median_s
    return f"{res.median_s * 1e3:.3f} ms ({spread:.1%})"


def graph_row(kernels, dia_kernels, launches, card, label, public, eager,
              check, flops, n_graphs=1, host_plan=False) -> None:
    """One row of phase 19 (module docstring): ``eager()`` and ``public()``
    timed, ``public()`` driven once (its launches counted) and checked,
    its graphs' numbers read from ``graphs.info()``. ``host_plan``: the
    call reads the host by design (binned's plan), so the sync debug
    check is left out."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import graphs
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    logdir = os.path.join("_scratch", "traces", "graphs")
    graphs.clear()
    torch.cuda.synchronize()
    if host_plan:
        ref = eager()
        sync_text = "host plan inside: no sync check"
    else:
        torch.cuda.set_sync_debug_mode("error")  # a host read raises
        try:
            ref = eager()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync_text = "eager ran under sync debug mode"
    eager_same = same_bits(eager(), ref)
    busy, window, n_k = busy_share(eager, logdir)
    peak = Peak("cuda").start()
    num_e = bench(eager, device="cuda", name=label, warmup=2, runs=5,
                  flops=flops)
    peak_e = peak.text()
    peak = Peak("cuda").start()
    # as bench.py times it: warm-up 1 eager, warm-up 2 captures
    num_g = bench(public, device="cuda", name=label, warmup=2, runs=5,
                  flops=flops)
    peak_g = peak.text()
    c, got = drive(kernels, dia_kernels, public)
    launches.update(got)
    info = graphs.info()
    gs = info["graphs"]
    if info["captures"] != n_graphs or len(gs) != n_graphs:
        raise AssertionError(f"{label}: {info}")
    pool = info["pool_bytes"]
    cap_ms = sum(g["capture_ms"] for g in gs)
    in_b = sum(g["in_bytes"] for g in gs)
    out_b = sum(g["out_bytes"] for g in gs)
    # K5 counts a plan's nnz(C) on the host's side of a call: no graph
    # holds it
    per_replay = {k: sum(g["launches"].get(k, 0) for g in gs) for k in got}
    what = check(c)
    bit = same_bits(c, ref)
    busy_g, window_g, n_kg = busy_share(public, logdir)
    rate = (f" = {num_e.gflops_median:.3f} GFlops" if flops else "",
            f" = {num_g.gflops_median:.3f} GFlops" if flops else "")
    phase(f"{label}: {what}; {sync_text}; {n_graphs} graph(s), capture "
          f"{cap_ms:.1f} ms, pool {pool / 2**30:.3f} GiB, "
          f"{min(g['replays'] for g in gs)} replays, launches a call "
          f"{per_replay}; a replay copies in {in_b / 2**20:.3f} MiB and "
          f"clones out {out_b / 2**20:.3f} MiB (the bodies' least "
          f"traffic, inputs read once and outputs written once: "
          f"{(in_b + out_b) / 2**20:.3f} MiB); eager {ms_spread(num_e)}"
          f"{rate[0]}, replay {ms_spread(num_g)}{rate[1]}, x"
          f"{num_e.median_s / num_g.median_s:.2f}; replay bit-equal to "
          f"eager: {bit} (eager to eager: {eager_same}); eager busy "
          f"{busy * 1e3:.3f} of {window * 1e3:.3f} ms = "
          f"{busy / window:.1%} ({n_k} kernels); replay seen by the "
          f"profiler: {busy_g * 1e3:.3f} of {window_g * 1e3:.3f} ms = "
          f"{busy_g / window_g:.1%} ({n_kg} kernels); eager "
          f"{peak_e}; graph {peak_g} [{card}]")
    if not bit and eager_same:
        raise AssertionError(f"{label}: the replay differs from the "
                             f"eager call, which repeats bit for bit")
    return got


def graph_paths(port, kernels, dia_kernels, launches, card: str,
                amg) -> None:
    """Phase 19 (module docstring): each GRAPH_PATHS and NEW_GRAPH_PATHS
    entry eager and replayed, the replay's behaviours, and the refresh
    beside the ESC graphs. ``amg``: phase 10's (matrix, hierarchies)."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

    row = functools.partial(graph_row, kernels, dia_kernels, launches, card)
    for name, path, dtype in GRAPH_PATHS:
        label = f"graphs {name} {path} {str(dtype)[6:]}"
        public, eager, check, flops = graph_operands(port, name, path, dtype)
        got = row(label, public, eager, check, flops)
        if path == "tilepack" and got["tile_sort_merge"] != 1:
            raise AssertionError(f"{label}: a replay counted {got}")
    graph_behaviours(port, graphs)
    a_sp, hier = amg
    a_new_sp = a_sp.copy()
    a_new_sp.data = (a_new_sp.data * np.float32(1.5)).astype(np.float32)
    a_new = port.CSR.from_scipy(a_new_sp, device="cuda")
    for name, path, dtype in NEW_GRAPH_PATHS:
        label = f"graphs {name} {path} {str(dtype)[6:]}"
        public, check, flops, n_graphs = new_graph_operands(
            port, name, path, dtype, hier, a_new, a_new_sp)

        def eager(public=public):
            with graphs.eager():
                return public()

        got = row(label, public, eager, check, flops, n_graphs,
                  host_plan=path == "binned")
        if path in ("tiled", "binned", "fused") and \
                got["bin_sort_compress"] <= 0:
            raise AssertionError(f"{label}: no K2 launch counted: {got}")
    refresh_beside_esc(port, graphs, hier, a_new, card)
    graphs.clear()


# (suite matrix, path, value type) of this slice's planned bodies
NEW_GRAPH_PATHS = (
    ("mc2depi_524k", "refresh unsmoothed", torch.float32),
    ("mc2depi_524k", "refresh smoothed", torch.float32),
    ("poisson2d_256", "triple", torch.float32),
    ("poisson2d_256", "aggrap", torch.float32),
    ("mc2depi_524k", "spadd", torch.float32),
    ("dense_rows_2k", "bsr", torch.float32),
    ("dense_rows_2k", "bsr", torch.bfloat16),
    ("banded_16k", "bsr", torch.float64),
    ("mc2depi_524k", "tiled", torch.float32),
    ("powerlaw_medium", "binned", torch.float32),
    ("powerlaw_medium", "fused", torch.float32),
    ("poisson2d_256", "ilu0 sweeps", torch.float32),
)


def new_graph_operands(port, name, path, dtype, hier, a_new, a_new_sp):
    """(public(), check(out) -> text, flops, graphs it captures) of one
    NEW_GRAPH_PATHS entry on the card. ``hier``/``a_new``: phase 10's
    mc2depi_524k hierarchies and its A x 1.5."""
    from benchmark_spgemm_using_csr_tpu_torch.models import amg, ilu0
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        aggrap,
        binned,
        bsr,
        fused,
        graphs,
        reuse,
        spadd,
        tiled,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )

    def csr_check(want, tol):
        def check(c):
            got = c.to_scipy().tocsr() if hasattr(c, "blocks") else c
            assert_csr_equal(got, want, check_explicit_zeros=False, **tol)
            return (f"nnz={want.nnz} verified against scipy (rtol "
                    f"{tol['rtol']:g})")
        return check

    if path.startswith("refresh"):
        h = hier[path == "refresh smoothed"]

        def check(h2):
            cur = a_new_sp.astype(np.float64)
            for li in range(1, len(h.levels)):
                rr = h.levels[li].r.to_scipy().astype(np.float64)
                pp = h.levels[li].p.to_scipy().astype(np.float64)
                cur = (rr @ (cur @ pp)).tocsr()
                assert_csr_equal(h2.levels[li].a, cur, **RAP_TOL)
            return (f"{len(h.levels) - 1} coarse levels "
                    f"{[k for k, _ in h._triple_plans[1:]]} verified against "
                    f"scipy R·A·P (rtol {RAP_TOL['rtol']:g})")

        return (lambda: amg.numeric_refresh(h, a_new), check, 0,
                len(h.levels) - 1)
    s = generators.SUITE[name]()
    if path in ("triple", "aggrap"):
        p_sp = amg.aggregation_prolongator(s).astype(np.float32).tocsr()
        r_sp = p_sp.T.tocsr()
        r, a, p = (port.CSR.from_scipy(x, device="cuda")
                   for x in (r_sp, s, p_sp))
        f64 = [x.astype(np.float64) for x in (r_sp, s, p_sp)]
        want = (f64[0] @ (f64[1] @ f64[2])).tocsr()
        if path == "triple":
            sched = reuse.make_triple_plan(r, a, p)
            public = lambda: reuse.spgemm_triple(r, a, p, sched)  # noqa: E731
        else:
            sched = aggrap.make_aggrap_plan(r, a, p)
            public = lambda: aggrap.rap_aggregation(a, sched)  # noqa: E731
        return public, csr_check(want, RAP_TOL), 0, 1
    if path == "spadd":
        a = port.CSR.from_scipy(s, device="cuda")
        at = port.csr_transpose(a)
        plan = spadd.make_add_plan(a, at)
        want = (s.astype(np.float64) + s.T.astype(np.float64)).tocsr()
        return (lambda: spadd.spadd_planned(a, at, plan),
                csr_check(want, dict(rtol=1e-3, atol=1e-3)), 0, 1)
    if path == "bsr":
        from benchmark_spgemm_using_csr_tpu_torch.bench import BSR_BLOCKS

        # bfloat16 operands are blocked in float32, as spgemm_bsr does
        s_in = port.CSR.from_scipy(s, dtype=dtype, device="cpu").to_scipy()
        a_b = port.BSR.from_scipy(s_in, BSR_BLOCKS[0], device="cuda")
        b_b = port.BSR.from_scipy(s_in, BSR_BLOCKS[1], device="cuda")
        plan = bsr.make_bsr_plan(a_b, b_b)
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        products = int(np.diff(s.indptr)[s.indices].sum())
        return (lambda: bsr.bsr_spgemm(a_b, b_b, plan),
                csr_check(spgemm_reference(s_in, s_in), tol),
                2 * products, 1)
    a = port.CSR.from_scipy(s, device="cuda")
    products = int(np.diff(s.indptr)[s.indices].sum())
    want = spgemm_reference(a, a)
    if path == "tiled":
        plan = tiled.make_tiled_plan(a, a)
        return (lambda: tiled.spgemm_tiled(a, a, plan),
                csr_check(want, F32_TOL), 2 * products, 1)
    if path == "fused":
        plan = fused.make_plan(a, a)
        return (lambda: fused.spgemm_fused(a, a, plan),
                csr_check(want, F32_TOL), 2 * products, 1)
    if path == "binned":
        plan = fused.make_plan(a, a)  # the same bins, as a count
        cap = products
        n = sum(r > 0 for r in plan.bin_rows) + (plan.tail_rows > 0)
        return (lambda: binned.spgemm_binned_host(a, a, cap),
                csr_check(want, F32_TOL), 2 * products, n)
    # the ILU0 sweeps: the planned body on ilu0()'s uploads, held against
    # the same recurrence in float64 numpy
    iplan = ilu0.ilu0_plan(s)
    host = (s.data.astype(np.float64), iplan.dep_l, iplan.dep_u,
            iplan.dep_mask, iplan.diag_pos, iplan.is_lower,
            iplan.col_of.astype(np.int64))
    args = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in host]
    args[0] = args[0].float()
    sweeps = ilu0.SweepPlan(10)
    v0, dl, du, dm, dp, lo, co = host
    v = v0
    for _ in range(sweeps.sweeps):
        t = np.where(dm, v[dl] * v[du], 0).sum(axis=1)
        v = np.where(lo, (v0 - t) / v[dp][co], v0 - t)

    def check(vals):
        np.testing.assert_allclose(vals.cpu().numpy(), v, rtol=1e-4,
                                   atol=1e-5)
        return (f"{vals.shape[0]} factor entries verified against the "
                f"sweeps in float64 numpy (rtol 1e-4), max_deps "
                f"{dl.shape[1]}")

    return (lambda: graphs.run(ilu0._sweep, sweeps, *args), check,
            0, 1)


def refresh_beside_esc(port, graphs, hier, a_new, card) -> None:
    """mc2depi_524k's unsmoothed refresh (9 coarse levels) interleaved with
    the four ESC paths of GRAPH_PATHS, four rounds: round 1 runs eager,
    round 2 captures each key once, rounds 3-4 capture nothing."""
    from benchmark_spgemm_using_csr_tpu_torch.models import amg

    graphs.clear()
    calls = []
    for name, make, run in (
            ("er_medium", port.make_tilepack_plan, port.spgemm_tilepack),
            ("powerlaw_medium", port.make_chunked_plan, port.spgemm_chunked),
            ("circuit_64k", port.make_grouped_plan, port.spgemm_grouped),
            ("scircuit_256k", port.make_grouped_plan, port.spgemm_grouped)):
        a = suite_csr(port, name)
        calls.append(functools.partial(run, a, a, make(a, a)))
    h = hier[False]
    levels = len(h.levels) - 1
    calls.append(lambda: amg.numeric_refresh(h, a_new))
    seen = []
    for _ in range(4):
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        seen.append(graphs.info()["captures"])
    info = graphs.info()
    want = [0] + [4 + levels] * 3
    phase(f"graphs: mc2depi_524k's unsmoothed refresh ({levels} coarse "
          f"levels) interleaved with the four ESC paths, captures after "
          f"each of 4 rounds {seen} (want {want}); {len(info['graphs'])} "
          f"graphs cached, {info['graph_bytes'] / 2**30:.3f} GiB of their "
          f"own inputs and outputs (budget "
          f"{graphs.MAX_GRAPH_BYTES / 2**30:.0f} GiB), pool "
          f"{info['pool_bytes'] / 2**30:.3f} GiB, {info['retired']} keys "
          f"retired [{card}]")
    if seen != want or info["retired"]:
        raise AssertionError(f"refresh beside ESC: captures {seen}, {info}")


def graph_behaviours(port, graphs) -> None:
    """Two calls return distinct storage; new values on the same structure
    give the new product; the out-of-core grouped blocks make one
    capture."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import batched
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )

    graphs.clear()
    a = suite_csr(port, "er_medium")
    sched = port.make_tilepack_plan(a, a)
    port.spgemm_tilepack(a, a, sched)
    port.spgemm_tilepack(a, a, sched)
    c1 = port.spgemm_tilepack(a, a, sched)
    keep = [t.clone() for t in (c1.rowptr, c1.colidx, c1.vals)]
    c2 = port.spgemm_tilepack(a, a, sched)
    ptrs = {t.data_ptr() for t in (c1.rowptr, c1.colidx, c1.vals, c2.rowptr,
                                   c2.colidx, c2.vals)}
    held = all(same_bits(t, k) for t, k in
               zip((c1.rowptr, c1.colidx, c1.vals), keep))
    if len(ptrs) != 6 or not held:
        raise AssertionError("two replays share storage or the first "
                             "changed")
    phase(f"graphs er_medium tilepack: two calls in a row return 6 "
          f"distinct buffers, the first unchanged by the second")
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.uniform(-1, 1, a.capacity).astype(np.float32))
    live = torch.arange(a.capacity) < int(a.rowptr[-1])
    a2 = port.CSR(a.rowptr, a.colidx, torch.where(live, v, 0).cuda(),
                  a.shape)
    assert_csr_equal(port.spgemm_tilepack(a2, a2, sched),
                     spgemm_reference(a2, a2), **F32_TOL)
    if graphs.info()["captures"] != 1:
        raise AssertionError(f"new values captured again: {graphs.info()}")
    phase("graphs er_medium tilepack: new values on the same structure "
          "replay the same graph and give the new product (verified "
          "against scipy)")
    del a, a2, c1, c2, keep
    graphs.clear()
    a = suite_csr(port, "circuit_64k")
    s = a.to_scipy()
    budget = -(-int(np.diff(s.indptr)[s.indices].sum()) // 3)
    t0 = time.perf_counter()
    c = port.spgemm_batched(a, a, stream_budget=budget, method="grouped")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plan = batched._cached_plan(a, a, budget, "grouped")
    info = graphs.info()
    assert_csr_equal(c, spgemm_reference(a, a), **F32_TOL)
    if plan.method != "grouped" or len(plan.blocks) < 3 or \
            info["captures"] != 1:
        raise AssertionError(f"out of core: {plan.method}, "
                             f"{len(plan.blocks)} blocks, {info}")
    g = info["graphs"][0]
    phase(f"graphs circuit_64k spgemm_batched(grouped, budget {budget}): "
          f"{len(plan.blocks)} blocks, {info['captures']} capture "
          f"({g['capture_ms']:.1f} ms, pool {info['pool_bytes'] / 2**30:.3f} "
          f"GiB, {g['replays']} replays), first call {wall * 1e3:.1f} ms, "
          f"verified against scipy")


# ---- phases 17-18: the reference's scripts, through their entry points ----


def entry_point(module: str, args, timeout_s: float) -> list[str]:
    """Run ``python -m <PKG>.scripts.<module> args`` in its own session,
    print its output a line at a time, and fail unless it exits 0; on its
    deadline the whole session (and the ranks it spawned) is killed."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.scripts.{module}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{module} passed its {timeout_s:.0f} s deadline")
    lines = [x for x in out.splitlines() if "socket.cpp" not in x]
    for line in lines:
        phase(f"  {line}")
    phase(f"{module} {' '.join(args)}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}")
    return lines


def scripts_phase() -> None:
    """Phases 17 and 18 (module docstring)."""
    results = os.path.join("_scratch", "scripts", "results_torch.jsonl")
    lines = entry_point("demo_large", ["--results", results], 900)
    if not any("check (a)" in x and "PASS" in x for x in lines) or not any(
            "check (b)" in x and "PASS" in x for x in lines):
        raise AssertionError("demo_large did not pass both checks")
    lines = entry_point("acceptance", ["--results", results], 600)
    if "ACCEPTANCE: ALL PASS" not in lines[-1]:
        raise AssertionError("acceptance did not pass every config")


class Laps:
    """Host seconds of each group of phases, printed as it ends."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        phase(f"[{what}: {now - self.last:.1f} s; {now - self.t0:.1f} s "
              f"since the start]")
        self.last = now


def kernel_entry(name, source, replaces, launches, numbers) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"{PKG}/csrc/{source}",
            "replaces": f"benchmark_spgemm_using_csr_tpu/{replaces}",
            "launches": launches[name], **numbers, "library_ms": None}


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    lap = Laps()
    kind = torch.cuda.get_device_name(0)
    phase(f"device: {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    # 2. name and power limit
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    phase(card)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    sm_mhz = float(clock.stdout.split()[0])
    phase(f"max SM clock {sm_mhz:.0f} MHz")

    import benchmark_spgemm_using_csr_tpu_torch as port
    from benchmark_spgemm_using_csr_tpu_torch.ops import (
        _build,
        dia_convert,
        dia_kernels,
        kernels,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.roofline import chip_spec

    global CHIP
    torch.cuda.set_device(0)
    CHIP = chip_spec(0)
    phase(f"roofline prices: {CHIP} (utils/roofline, {kind})")
    # 3. build K1, K2, K3, K4 at once
    t0 = time.perf_counter()
    for name, secs in _build.build_cuda().items():
        phase(f"built csrc/{name}.cu for sm_90a in {secs:.2f} s")
    phase(f"all kernels built in {time.perf_counter() - t0:.2f} s")
    resource_usage(_build)
    rng = np.random.default_rng(0)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    if sys.argv[1:] == ["k5"]:
        time_k5(port, flush)
        return 0
    if sys.argv[1:] == ["k6"]:
        time_k6(port, flush)
        return 0
    if sys.argv[1:] == ["k7"]:
        time_k7(port, flush)
        suite_picks(port)
        return 0
    # 4-6. each kernel against its plain version, and timed
    k1 = time_k1(port, kernels, sm_mhz * 1e6)
    k1["max_abs_err"] = max(k1["max_abs_err"], check_k1(kernels, rng))
    k2 = time_k2(port, kernels, sm_mhz * 1e6)
    k2["max_abs_err"] = max(k2["max_abs_err"], check_k2(kernels, rng))
    k3_err = check_k3(port, dia_kernels, rng)
    k3_all = time_k3(port, dia_kernels, flush)
    k3 = dict(k3_all["mc2depi_524k"])
    k3["max_abs_err"] = max([k3_err] + [v["max_abs_err"]
                                        for v in k3_all.values()])
    k4 = time_k4(port, dia_convert, flush)
    k5_all = time_k5(port, flush)
    k5 = dict(k5_all["circuit_262k"], max_abs_err=0)
    k6 = dict(time_k6(port, flush)["fem_81k"], max_abs_err=0)
    k7 = dict(time_k7(port, flush)["webbase_1m"], max_abs_err=0)
    del flush
    lap("phases 1-6")
    # 7-9. the paths; only their launches count
    suite_picks(port)
    launches = collections.Counter()
    main_path(port, kernels, dia_kernels, launches)
    tiled_binned_paths(port, kernels, dia_kernels, launches)
    library_paths(port, kernels, dia_kernels, launches)
    lap("phases 7-9")
    # 10. the AMG / ILU0 solver path (its coarsest dense LU takes ~57 GiB)
    # beside the graphs phases 7-9 left cached, as a caller's would be
    from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

    held = graphs.info()
    phase(f"graphs held after phases 7-9: {len(held['graphs'])}, pool "
          f"{held['pool_bytes'] / 2**30:.3f} GiB: "
          + ", ".join(f"{g['fn']} ({g['replays']} replays)"
                      for g in held["graphs"]))
    amg = solver_paths(port, kernels, dia_kernels, launches, card)
    held = graphs.info()
    phase(f"graphs held after phase 10: {len(held['graphs'])} "
          f"({held['graph_bytes'] / 2**30:.3f} GiB of their own inputs and "
          f"outputs, {held['retired']} keys retired), pool "
          f"{held['pool_bytes'] / 2**30:.3f} GiB [{card}]")
    lap("phase 10")
    # 12. bfloat16 through auto; 13. profiles; 14. the roofline shares
    bf16_paths(port, kernels, dia_kernels, launches)
    profile_paths(port, os.path.join("_scratch", "traces"))
    roofline_phase(card)
    lap("phases 12-14")
    # 15. the distributed schedules (no kernel of K1-K4 on their path)
    dist_phase(card)
    phase(f"launches on the paths: {dict(launches)}")
    for name in ("tile_sort_merge", "bin_sort_compress", "dia_spgemm_fused",
                 "dia_to_csr", "symbolic_count"):
        if launches[name] <= 0:
            raise AssertionError(f"the paths never launched {name}")
    cli_ops()
    # 11. the CLI
    cli_run()
    lap("phases 15 and 11")
    # 19. the planned phases as CUDA graphs against eager
    graph_paths(port, kernels, dia_kernels, launches, card, amg)
    del amg
    lap("phase 19")
    # 16. the suite harness
    bench_phase(launches)
    lap("phase 16")
    # 17-18. the large-scale demo and the acceptance driver
    scripts_phase()
    lap("phases 17-18")

    print(json.dumps({"kernels": [
        kernel_entry("tile_sort_merge", "tile_sort_merge.cu",
                     "ops/pallas_kernels.py:258", launches, k1),
        kernel_entry("bin_sort_compress", "bin_sort_compress.cu",
                     "ops/pallas_kernels.py:139", launches, k2),
        kernel_entry("dia_spgemm_fused", "dia_spgemm_fused.cu",
                     "ops/dia_pallas.py:57", launches, k3),
        kernel_entry("dia_to_csr", "dia_to_csr.cu",
                     "sparse/dia.py:80 (DIA.to_csr, on the host)",
                     launches, k4),
        kernel_entry("symbolic_count", "symbolic_count.cu",
                     "ops/grouped.py:322 (scipy's pattern product, on the "
                     "host)", launches, k5),
        kernel_entry("rowlocal_esc", "rowlocal_esc.cu",
                     "none (ops/chunked's product stream: its sort, "
                     "run-sum and compaction)", launches, k6),
        kernel_entry("pair_stats", "pair_stats.cu",
                     "none (ops/dispatch's numpy pricing, on the host)",
                     launches, k7),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
