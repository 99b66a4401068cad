"""A/B of kernel K3 on the card: the redesigned kernel against the one it
replaced, and where the new kernel's time goes. From the repository's
root, on a CUDA device:

    git show 871c00e:benchmark_spgemm_using_csr_tpu_torch/csrc/dia_spgemm_fused.cu \\
        > _scratch/k3_old.cu
    python3 -m benchmark_spgemm_using_csr_tpu_torch.tools.k3_ab \\
        _scratch/k3_old.cu [matrix ...]

On the planes of each matrix (A @ A; default: the suite's DIA members
within K3's span, float32, and chip_smoke.F64_MATRICES also in float64),
in one process on one card:

- the old kernel (the source given: one thread per output slot, its
  per-plane term table) and the current K3 through its wrapper, each first
  checked bit for bit against the gather form, then timed in turns (old,
  new, new, old): torch.profiler's kernel time (mean of 10 calls, each
  after a 128 MB L2 flush) and CUDA events over batches of 10 calls;
- builds of the current source under its A/B switches (K3_MIN_BLOCKS 1
  and 2, each with the plan's warps and, for a 16-warp plan, 8): the
  blocks an SM holds at once (the occupancy query) and the profiler's
  time, each result bit-equal to the gather form; then its copies alone
  (K3_PART=1) and its sums alone (K3_PART=2, reading whatever shared
  memory holds), results discarded;
- float32 only: the current kernel under the plan of every tile width of
  ``TILES`` and two shared-memory budgets (a block per SM pair, and one
  block's most), each bit-equal: the profiler's time beside the plan's
  own pick.

Also prints the registers and local memory of every build's staged
instances. Prints a few lines per matrix.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import os
import shutil
import sys

import numpy as np
import torch

import chip_smoke

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = [P] * 5 + [I, LL, LL, I, P]
NEW_ARGS = [P] * 7 + [I, LL, I, LL, LL, I, I, I, I, I, P]
# builds of the current source under its compile-time switches
VARIANTS = {
    "min_blocks_1": ("-DK3_MIN_BLOCKS=1",),
    "min_blocks_2": ("-DK3_MIN_BLOCKS=2",),
    "copies_only": ("-DK3_PART=1",),
    "sums_only": ("-DK3_PART=2",),
}


def build(bld, src: str, flags=()):
    """``src`` built with nvcc for sm_90a into ``_build/`` and loaded."""
    cmd = [bld.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", *flags]
    return bld.shared_library(src, cmd)


def variant_libs(bld) -> dict:
    """Every VARIANTS build of ``csrc/dia_spgemm_fused.cu``, all at once
    (a copy of the source each, so that each has its own library)."""
    src = os.path.join(bld.CSRC_DIR, "dia_spgemm_fused.cu")
    os.makedirs(bld.BUILD_DIR, exist_ok=True)

    def one(name):
        path = os.path.join(bld.BUILD_DIR, f"k3_{name}.cu")
        shutil.copyfile(src, path)
        lib = build(bld, path, VARIANTS[name])
        lib.dia_spgemm_fused_launch.argtypes = NEW_ARGS
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def old_call(lib, a, out, plane_ptr, terms):
    err = lib.dia_spgemm_fused_launch(
        a.data.data_ptr(), a.data.data_ptr(), out.data_ptr(),
        plane_ptr.data_ptr(), terms.data_ptr(), out.shape[0], a.n, a.n,
        int(out.element_size() == 8), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K3 launch failed: CUDA error {err}")


def plan_call(lib, a, out, plan, tables):
    """The K3 entry point of ``lib`` on A @ A under ``plan``."""
    err = lib.dia_spgemm_fused_launch(
        a.data.data_ptr(), a.data.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in tables), len(plan.groups), plan.ntiles,
        plan.tile, a.n, a.n, plan.smem, plan.lanes, plan.warps,
        int(plan.staged), int(out.element_size() == 8),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")


def on_card(plan):
    return tuple(torch.from_numpy(x).cuda() for x in (
        plan.groups, plan.rows, plan.plane_terms, plan.terms))


def ms(x):
    return "n/a" if x is None else f"{x:.4f}"


def checked(fn, out, want, what: str):
    fn()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"K3 differs from the gather form: {what}")


def ab(port, dia_kernels, libs, old, current, flush, name: str,
       dtype) -> None:
    """The A/B lines of one matrix in one type (see the module's doc)."""
    a = port.DIA.from_csr(chip_smoke.suite_csr(port, name), device="cuda")
    a = port.DIA(a.data.to(dtype), a.offsets, a.shape)
    off = tuple(a.offsets)
    size = a.data.element_size()
    label = f"{name} ({torch.finfo(dtype).bits}-bit)"
    want = dia_kernels.gather_form(a, a).data
    off_c, by_dc = dia_kernels.plan_terms(off, off)
    counts = [len(by_dc[dc]) for dc in off_c]
    plane_ptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).cuda()
    terms = torch.tensor([t for dc in off_c for t in by_dc[dc]],
                         dtype=torch.int32, device="cuda")
    out = torch.empty_like(want)
    run_old = functools.partial(old_call, old, a, out, plane_ptr, terms)
    checked(run_old, out, want, f"old kernel on {label}")
    run_new = functools.partial(dia_kernels.dia_spgemm_fused, a, a)
    if not torch.equal(run_new().data, want):
        raise AssertionError(f"K3 differs on {label}")
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = run_old if which == "old" else run_new
        times[which].append(
            (chip_smoke.profiler_ms(fn, "dia_spgemm_kernel", flush),
             chip_smoke.cuda_ms(fn, flush=flush, batch=10)))
    bound_ms = chip_smoke.k3_bound(dia_kernels, a, a)[0]

    def fmt(pairs):
        return " / ".join(f"{ms(p)} ({ms(b)})" for p, b in pairs)

    chip_smoke.phase(
        f"{label} (n={a.n}, {a.ndiag} diagonals): profiler ms (batches of "
        f"10): old {fmt(times['old'])}; new {fmt(times['new'])}; bound "
        f"{bound_ms * 1e3:.1f} us")
    plan = dia_kernels.launch_plan(off, off, a.n, size)
    tables = on_card(plan)
    cells = []
    for build_name in ("min_blocks_1", "min_blocks_2"):
        lib = libs[build_name]
        for warps in sorted({plan.warps, 8} if plan.staged else {8}):
            alt = dataclasses.replace(plan, warps=warps)
            fn = functools.partial(plan_call, lib, a, out, alt, tables)
            checked(fn, out, want, f"{build_name}, {warps} warps, {label}")
            blocks = chip_smoke.k3_blocks_per_sm(lib, alt, size)
            t = chip_smoke.profiler_ms(fn, "dia_spgemm_kernel", flush)
            cells.append(f"{build_name} {warps} warps: {blocks} blocks/SM "
                         f"{ms(t)}")
    parts = {}
    for part in ("copies_only", "sums_only"):
        fn = functools.partial(plan_call, libs[part], a, out, plan, tables)
        parts[part] = chip_smoke.profiler_ms(fn, "dia_spgemm_kernel", flush)
    chip_smoke.phase(
        f"{label}: plan {chip_smoke.plan_text(plan)}; profiler ms: "
        f"{'; '.join(cells)}; copies only {ms(parts['copies_only'])}, sums "
        f"only {ms(parts['sums_only'])}")
    if dtype == torch.float32:
        cells = []
        for budget in (dia_kernels.SMEM_BUDGET, dia_kernels.SMEM_MAX):
            for tile in dia_kernels.TILES:
                alt = dia_kernels._plan(off, off, a.n, size, (tile,), budget)
                fn = functools.partial(plan_call, current, a, out, alt,
                                       on_card(alt))
                checked(fn, out, want, f"tile {tile}, budget {budget}, "
                        f"{label}")
                t = chip_smoke.profiler_ms(fn, "dia_spgemm_kernel", flush)
                cells.append(f"{tile}/{budget // 1024}K {ms(t)}"
                             f"{'' if alt.staged else ' direct'}")
        chip_smoke.phase(f"{label}: plans, tile/budget ms: "
                         f"{'; '.join(cells)} (the plan picks tile "
                         f"{plan.tile})")
    del a, want, out
    torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available() or not argv:
        raise SystemExit(__doc__)
    import benchmark_spgemm_using_csr_tpu_torch as port
    from benchmark_spgemm_using_csr_tpu_torch.ops import _build, dia_kernels

    old = build(_build, argv[0])
    old.dia_spgemm_fused_launch.argtypes = OLD_ARGS
    libs = variant_libs(_build)
    current = _build.cuda_library("dia_spgemm_fused")
    current.dia_spgemm_fused_launch.argtypes = NEW_ARGS
    for build_name in ("dia_spgemm_fused", *(f"k3_{v}" for v in VARIANTS)):
        usage = [(fn, reg, loc)
                 for fn, reg, loc in chip_smoke.res_usage(_build, build_name)
                 if "staged" in fn]
        chip_smoke.phase(f"{build_name}: staged registers (local bytes): "
                         + ", ".join(f"{chip_smoke.k3_instance(fn)} {reg} "
                                     f"({loc})" for fn, reg, loc in usage))
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    names = argv[1:] or [n for n in chip_smoke.DIA_MATRICES
                         if n != "consph_83k"]
    for name in names:
        ab(port, dia_kernels, libs, old, current, flush, name, torch.float32)
        if name in chip_smoke.F64_MATRICES:
            ab(port, dia_kernels, libs, old, current, flush, name,
               torch.float64)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
