"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one line (or a few):

1. require ``torch.cuda.is_available()``;
2. the card's name and power limit, and its max SM clock (nvidia-smi);
3. build the hand-written kernels K1 (``tile_sort_merge``), K2
   (``bin_sort_compress``) and K3 (``dia_spgemm_fused``) from
   ``benchmark_spgemm_using_csr_tpu_torch/csrc`` with nvcc for sm_90a, one
   nvcc process each, all at once; then the registers and local memory
   (spills) of every K1/K2 instantiation, as cuobjdump reads them;
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
6. K3 against its plain version on synthetic cases (poisson, asymmetric
   banded A.B, n not a multiple of the 4096-column block, rectangular, an
   empty operand, float64) and on the planes of mc2depi_524k, stencil27_32
   and pdb_8k: offsets equal, values within rtol/atol 1e-6 (designed to be
   bit-equal; the line says whether they are). K3 and its plain version,
   which is the gather form that ``dia_spgemm(fused=False)`` runs, timed
   on the three matrices with CUDA events, the L2 cache flushed by a
   128 MB write before every timed launch;
7. the main path, ``spgemm(A, A, method="auto")``, on er_medium,
   powerlaw_medium, circuit_64k, scircuit_256k, mc2depi_524k,
   poisson2d_256 and stencil27_32 at full size: the dispatcher's pick and
   its host time (and that of its dia estimate), the kernels' launch
   counts, the result against scipy at the CLI's float32 tolerances, the
   host time of the plan (for dia: CSR -> DIA planes), and the median time
   and GFlops (2 * products / t) of the numeric phase (plan, or DIA
   planes, built beforehand) and of the whole call;
8. ``spgemm(A, A, method="tiled")`` on poisson2d_256 and mc2depi_524k, and
   ``spgemm_binned_host`` on powerlaw_medium (whose rows over 512 products
   take the ESC tail): verified, K2 launched, the numeric median timed;
9. the CLI, ``python -m benchmark_spgemm_using_csr_tpu_torch
   suite:er_medium --json --runs 3``, in a subprocess.

The launch counts of phases 7 and 8 are set to 0 just before each path is
driven through its entry point and read just after; the kernels line and
the must-launch checks read those counts alone. The comparisons of phases
4-6 and the timing runs of phases 7-8 do not count.
Any failure raises and the exit code is not 0. The line before the last
is one JSON object on the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
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
    "mc2depi_524k": "dia",  # through K3 (the reference's fused gate)
    "poisson2d_256": "dia",  # gather form (n < 2^18)
    "stencil27_32": "dia",  # gather form (729 terms)
}
# main-path matrices whose run must launch the named kernel
MUST_LAUNCH = {"er_medium": "tile_sort_merge",
               "mc2depi_524k": "dia_spgemm_fused"}
K3_MATRICES = ("mc2depi_524k", "stencil27_32", "pdb_8k")
F32_TOL = dict(rtol=1e-4, atol=1e-5)  # the CLI's float32 verify tolerances
K1_TOL = dict(rtol=1e-6, atol=1e-6)
K2_TOL = K1_TOL  # the same addition tree as the plain version
K1_WIDTHS = (128, 256, 512, 1024, 2048)  # tile_sort_merge.cu's launch switch
K2_WIDTHS = tuple(1 << i for i in range(1, 12))  # bin_sort_compress.cu's
K3_TOL = dict(rtol=1e-6, atol=1e-6)  # bit-equal by design (no FMA)
# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SMS, LANES_PER_SM = 132, 128  # H100 SXM: 4 schedulers x 32 lanes per SM
PKG = "benchmark_spgemm_using_csr_tpu_torch"


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


def bound(nbytes: int, flops: int = 0):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def time_tiles(name, what, fn, plain, keys, nbytes, sm_hz) -> dict:
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
    bound_ms, bound_by = bound(nbytes)
    r, w = keys.shape
    lw = w.bit_length() - 1
    cmpx = r * (w // 2) * lw * (lw + 1) // 2
    floor_ms = cmpx / (SMS * LANES_PER_SM * sm_hz) * 1e3
    phase(f"{name} on {what}: kernel {ms:.4f} ms ({alone_ms:.4f} alone), "
          f"plain {plain_ms:.4f} ms, torch.sort of the keys {sort_ms:.4f} ms "
          f"(CUDA events, median of 10 batches of 10); bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB at 3.35 "
          f"TB/s; the kernel at {bound_ms / ms:.1%} of it); network floor "
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
    # 20 B per lane (key + val read; key, val, pos written) + the counts
    nbytes = r * w * 20 + r * kw["wlr"] * 4
    return dict(time_tiles("K1", what, fn, plain, key, nbytes, sm_hz),
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
    first, worst = None, 0.0
    for what, col, val, n in k2_path_tiles(port):
        fn = functools.partial(kernels.bin_sort_compress, col, val,
                               n_sentinel=n)
        plain = functools.partial(kernels.bin_sort_compress_plain, col, val,
                                  n_sentinel=n)
        worst = max(worst, compare_tiles("K2", fn(), plain(), K2_TOL, what))
        r, w = col.shape
        # col + val read; col, val, pos written; the per-row counts
        nbytes = r * w * (12 + 2 * val.element_size()) + r * 4
        numbers = time_tiles("K2", what, fn, plain, col, nbytes, sm_hz)
        first = first or numbers
    return dict(first, max_abs_err=worst)


def resource_usage(build) -> None:
    """Registers and local memory (where spills would go) per thread of
    every K1/K2 instantiation, as cuobjdump reads them from the built
    libraries."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name in ("tile_sort_merge", "bin_sort_compress"):
        lib = os.path.join(build.BUILD_DIR, f"lib{name}.so")
        out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                             text=True, timeout=120, check=True).stdout
        usage, fn = [], ""
        for line in out.splitlines():
            m = re.search(r"Function (\S+):", line)
            fn = m.group(1) if m else fn
            m = re.search(r"REG:(\d+) .*LOCAL:(\d+)", line)
            w = re.search(r"kernelI([fd]?)Li(\d+)E", fn)
            if m and w:
                usage.append((w.group(1), int(w.group(2)), int(m.group(1)),
                              int(m.group(2))))
        phase(f"csrc/{name}.cu registers (local bytes) per thread: " + ", ".join(
            f"{'double ' if t == 'd' else ''}W={w}: {reg} ({loc})"
            for t, w, reg, loc in sorted(usage)))


# ---- K3 --------------------------------------------------------------------


def compare_dia(dia_kernels, a, b, what: str) -> float:
    """K3 against its plain version: offsets equal, values within K3_TOL.
    Returns the max abs difference."""
    got = dia_kernels.dia_spgemm_fused(a, b)
    want = dia_kernels.dia_spgemm_fused_plain(a, b)
    torch.cuda.synchronize()
    if got.offsets != want.offsets or got.dtype != want.dtype:
        raise AssertionError(f"K3 offsets or type differ on {what}")
    torch.testing.assert_close(got.data, want.data, **K3_TOL)
    err = float((got.data - want.data).abs().max())
    phase(f"K3 on {what}: {len(got.offsets)} output planes, offsets equal, "
          f"bit-equal {torch.equal(got.data, want.data)}, max |diff| "
          f"{err:.3g}")
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
    }
    return max(compare_dia(dia_kernels, a, b, what)
               for what, (a, b) in cases.items())


def time_k3(port, dia_kernels, flush) -> dict:
    """K3 against its plain version on the planes of the three DIA
    matrices, then both timed on each. The plain version is the gather form
    (``dia_spgemm(fused=False)``), so its time is also ``gather_ms``.
    Returns {matrix: numbers}."""
    out = {}
    for name in K3_MATRICES:
        a = port.DIA.from_csr(suite_csr(port, name), device="cuda")
        nd, n = a.ndiag, a.n
        off_c, terms = dia_kernels.plan_terms(a.offsets, a.offsets)
        err = compare_dia(dia_kernels, a, a, f"{name}'s planes ({nd} "
                          f"diagonals, {nd * nd} terms)")
        ms = cuda_ms(lambda: dia_kernels.dia_spgemm_fused(a, a), flush=flush)
        plain_ms = cuda_ms(lambda: dia_kernels.dia_spgemm_fused_plain(a, a),
                           flush=flush)
        # each plane read or written once; 2 flops per term slot whose A
        # read falls inside the matrix
        nbytes = (2 * nd + len(off_c)) * n * a.data.element_size()
        flops = 2 * sum(max(0, min(n, a.n + d2) - max(0, d2))
                        for dc in off_c for _, _, d2 in terms[dc])
        bound_ms, bound_by = bound(nbytes, flops)
        phase(f"K3 on {name}: kernel {ms:.4f} ms, plain = gather form "
              f"{plain_ms:.4f} ms (CUDA events, median of 10, L2 flushed); "
              f"bound {bound_ms * 1e3:.1f} us by {bound_by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.1f} MFLOP)")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         gather_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        del a
    return out


# ---- the paths ---------------------------------------------------------------


def counts(kernels, dia_kernels) -> dict:
    return {
        "tile_sort_merge": kernels.tile_sort_merge.launches,
        "bin_sort_compress": kernels.bin_sort_compress.launches,
        "dia_spgemm_fused": dia_kernels.dia_spgemm_fused.launches,
    }


def reset_counts(kernels, dia_kernels) -> None:
    kernels.tile_sort_merge.launches = 0
    kernels.bin_sort_compress.launches = 0
    dia_kernels.dia_spgemm_fused.launches = 0


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
    plan = port.make_chunked_plan(a, a)
    return lambda: port.spgemm_chunked(a, a, plan)


def report(port, a, name, method, run, launched, products, c):
    """Verify C against scipy, time the numeric phase (and the whole
    call), print one line."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
        assert_csr_equal,
        spgemm_reference,
    )
    from benchmark_spgemm_using_csr_tpu_torch.utils.timing import bench

    assert_csr_equal(c, spgemm_reference(a, a), **F32_TOL)
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


def drive(kernels, dia_kernels, run):
    """One path run with the launch counts set to 0 just before it and
    read just after. Returns (C, counts)."""
    reset_counts(kernels, dia_kernels)
    c = run()
    torch.cuda.synchronize()
    return c, counts(kernels, dia_kernels)


def main_path(port, kernels, dia_kernels, launches) -> None:
    """``spgemm(A, A, method="auto")`` on the EXPECTED matrices."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.dispatch import (
        estimate_dia_s,
    )

    for name, want_method in EXPECTED.items():
        a = suite_csr(port, name)
        products = port.spgemm_flops(a, a) // 2
        t0 = time.perf_counter()
        method = port.choose_method(a, a)
        t1 = time.perf_counter()
        estimate_dia_s(a, a)  # its share of the pick (structure memoized)
        phase(f"{name}: choose_method {(t1 - t0) * 1e3:.1f} ms, of which "
              f"the dia estimate {(time.perf_counter() - t1) * 1e3:.1f} ms "
              f"(host clock)")
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


def cli_run() -> None:
    out = subprocess.run(
        [sys.executable, "-m", PKG, "suite:er_medium", "--json", "--runs",
         "3"],
        capture_output=True, text=True, timeout=600, check=True,
    )
    record = json.loads(out.stdout.strip().splitlines()[-1])
    if record.get("verified") is not True:
        raise AssertionError(f"CLI run not verified: {record}")
    phase(f"CLI suite:er_medium: verified, mean {record['mean_s'] * 1e3:.3f} "
          f"ms, {record['gflops']:.3f} GFlops on {record['device']}")


def kernel_entry(name, source, replaces, launches, numbers) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"{PKG}/csrc/{source}",
            "replaces": f"benchmark_spgemm_using_csr_tpu/{replaces}",
            "launches": launches[name], **numbers, "library_ms": None}


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    phase(f"device: {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    # 2. name and power limit
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    phase(smi.stdout.strip().splitlines()[0])
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
        dia_kernels,
        kernels,
    )

    torch.cuda.set_device(0)
    # 3. build K1, K2, K3 at once
    t0 = time.perf_counter()
    for name, secs in _build.build_cuda().items():
        phase(f"built csrc/{name}.cu for sm_90a in {secs:.2f} s")
    phase(f"all kernels built in {time.perf_counter() - t0:.2f} s")
    resource_usage(_build)
    rng = np.random.default_rng(0)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
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
    del flush
    # 7-8. the paths; only their launches count
    launches = collections.Counter()
    main_path(port, kernels, dia_kernels, launches)
    tiled_binned_paths(port, kernels, dia_kernels, launches)
    phase(f"launches on the paths: {dict(launches)}")
    for name in ("tile_sort_merge", "bin_sort_compress", "dia_spgemm_fused"):
        if launches[name] <= 0:
            raise AssertionError(f"the paths never launched {name}")
    # 9. the CLI
    cli_run()

    print(json.dumps({"kernels": [
        kernel_entry("tile_sort_merge", "tile_sort_merge.cu",
                     "ops/pallas_kernels.py:258", launches, k1),
        kernel_entry("bin_sort_compress", "bin_sort_compress.cu",
                     "ops/pallas_kernels.py:139", launches, k2),
        kernel_entry("dia_spgemm_fused", "dia_spgemm_fused.cu",
                     "ops/dia_pallas.py:57", launches, k3),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
