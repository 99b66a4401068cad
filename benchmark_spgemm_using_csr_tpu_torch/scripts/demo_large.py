"""Large-scale demo: C = A @ A on a scale-free matrix at the size of the
reference's large-scale record (``results.jsonl:65``: 76.7M nonzeros,
1.39B products, nnz(C) 1.39B) on one card, through the out-of-core path
``ops/batched.spgemm_batched``, after the reference's
``scripts/demo_large.py``.

    python -m benchmark_spgemm_using_csr_tpu_torch.scripts.demo_large
        [--nnz 50e6] [--budget 32e6] [--check-sample 512] [--m 4194304]
        [--device cuda] [--results bench_out/results_torch.jsonl]

A is ``utils/generators.power_law(m, m, alpha=2.3, min_deg=max(int(nnz /
m * 0.5), 1), max_deg=4096, seed=7)`` with m = 2^22, the reference's.
``--nnz`` is a target the generator misses: the minimum row length
carries it. Any ``--nnz`` in [41.95e6, 50.33e6) gives min_deg 5 and the
record's matrix. The reference's default, 100e6, gives min_deg 11: 164M
nonzeros, 6.38B products and an nnz(C) past 2^31 - 1, which C's int32
row pointer cannot count, so the plan refuses it; the default here is
50e6. The first call builds the plan and returns C as a host scipy CSR, as the
reference's does; its GFlops is the products' flops over the whole call. A
second call runs on the cached plan and keeps C on the device: its device
time by CUDA events and its wall time on the host clock. One line a
measurement; then two checks of the first call's C, each of which fails
the run (exit 1):

(a) the reference's sampled rows (``default_rng(0)``) against scipy's
    ``A[rows] @ A`` by ``utils/oracle.assert_csr_equal`` with the
    operands: the structure exactly (an entry in one structure only
    within its terms' rounding bound), the values within the float32
    tolerance;
(b) the whole C through a vector: y = C x against A (A x), both in
    float64 on the host, x standard normal from a fixed seed. Row i may
    differ by k_i * eps * (|A| (|A| |x|))_i, k_i its count of products:
    each C_ij is a sum of k_ij <= k_i products, within k_ij * eps / 2 of
    their absolute sum whatever the order of addition.

One row goes to ``--results``, never to the reference's results.jsonl.
The entry point runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import resource
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..bench import DEFAULT_RESULTS, card_text, sync
from ..ops import batched, graphs
from ..sparse.csr import CSR
from ..utils import generators
from ..utils.oracle import TOLERANCES, assert_csr_equal
from ..utils.results import write_result

DEFAULT_M = 1 << 22
DEFAULT_NNZ = 50e6
# the reference's large-scale record (results.jsonl:65), whose A is this
# generator's at m = 2^22 and min_deg 5: the same seed gives the same
# counts unless numpy's stream moved
REFERENCE = {"m": DEFAULT_M, "min_deg": 5, "nnz_a": 76_738_371,
             "nnz_c": 1_385_699_373}
VECTOR_SEED = 1


def min_deg(nnz: float, m: int) -> int:
    """The generator's shortest row for a target of ``nnz`` nonzeros."""
    return max(int(nnz / m * 0.5), 1)


def make_matrix(nnz: float, m: int = DEFAULT_M) -> sp.csr_matrix:
    """The demo's A: scale-free rows, hubs bounded at 4096 entries."""
    return generators.power_law(m, m, alpha=2.3, min_deg=min_deg(nnz, m),
                                max_deg=4096, seed=7)


def sampled_check(a_sp, c_sp, rows) -> tuple[bool, str]:
    """Check (a): C's ``rows`` against scipy's A[rows] @ A."""
    a_rows = a_sp[rows]
    want = (a_rows @ a_sp).tocsr()
    try:
        one_side = assert_csr_equal(c_sp[rows], want,
                                    factors=(a_rows, a_sp),
                                    **TOLERANCES[str(c_sp.dtype)])
    except AssertionError as e:
        return False, str(e).strip().splitlines()[0][:300]
    return True, (f"{len(rows)} rows, {want.nnz:,} entries equal; "
                  f"{one_side} in one structure only, within their bound")


def matvec64(c_sp, x, chunk: int = 1 << 26) -> np.ndarray:
    """C x in float64, C's values widened a row block of at most ``chunk``
    entries at a time."""
    y = np.zeros(c_sp.shape[0])
    for lo, hi in batched.plan_row_batches(np.diff(c_sp.indptr), chunk):
        s0, s1 = int(c_sp.indptr[lo]), int(c_sp.indptr[hi])
        blk = sp.csr_matrix(
            (c_sp.data[s0:s1].astype(np.float64), c_sp.indices[s0:s1],
             c_sp.indptr[lo:hi + 1] - s0), shape=(hi - lo, c_sp.shape[1]))
        y[lo:hi] = blk @ x
    return y


def vector_check(a_sp, c_sp, products, seed: int = VECTOR_SEED
                 ) -> tuple[bool, str]:
    """Check (b): y = C x against A (A x) in float64, row i within
    products[i] * eps * (|A| (|A| |x|))_i (module docstring)."""
    x = np.random.default_rng(seed).standard_normal(a_sp.shape[1])
    a64 = a_sp.astype(np.float64)
    want = a64 @ (a64 @ x)
    a64.data = np.abs(a64.data)
    scale = a64 @ (a64 @ np.abs(x))
    bound = products * float(np.finfo(c_sp.dtype).eps) * scale
    err = np.abs(matvec64(c_sp, x) - want)
    bad = np.flatnonzero(err > bound)
    worst = float((err / np.where(bound > 0, bound, 1.0)).max(initial=0.0))
    if bad.size:
        i = int(bad[0])
        return False, (f"{bad.size} of {len(err)} rows off by more than "
                       f"their bound (row {i}: |error| {err[i]:.3g} > "
                       f"{bound[i]:.3g})")
    return True, (f"{len(err):,} rows within their bound (largest "
                  f"|error| / bound {worst:.3g})")


@dataclasses.dataclass
class Demo:
    record: dict  # what the run measured and checked (the results row)
    a: sp.csr_matrix  # A on the host
    c: sp.csr_matrix  # the first call's C


def gib(nbytes: float) -> float:
    return nbytes / (1 << 30)


def rss_bytes() -> int:
    """The host's peak resident set of this process (ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(nnz: float = DEFAULT_NNZ, budget: float = 32e6,
        check_sample: int = 512, *, device, m: int = DEFAULT_M,
        method: str | None = None, say=print) -> Demo:
    """The demo at ``m`` rows (the reference's 2^22 by default); ``method``
    forces the blocks' method (default: the plan's pick). Raises when
    ``budget`` would hold the whole product (the call would run in core)
    or when a CUDA device is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available")
    card = card_text(dev)
    say(f"device: {torch.cuda.get_device_name(dev) if card else dev}"
        + (f" ({card})" if card else ""))
    say(f"generating scale-free matrix: m={m:,}, target nnz~{int(nnz):,} "
        f"(min_deg {min_deg(nnz, m)})")
    t0 = time.perf_counter()
    a_sp = make_matrix(nnz, m)
    gen_s = time.perf_counter() - t0
    say(f"  generated nnz_a={a_sp.nnz:,} in {gen_s:.1f} s (host)")
    t0 = time.perf_counter()
    a = CSR.from_scipy(a_sp, device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0
    products = batched.row_products(a_sp, a_sp.indptr)
    total = int(products.sum())
    flops = 2 * total
    say(f"  A on {dev} in {upload_s:.1f} s; intermediate products "
        f"{total:,} (flops {flops:,})")
    if total <= int(budget):
        raise ValueError(f"budget {int(budget):,} holds all {total:,} "
                         "products: the call would run in core")

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    c_sp = batched.spgemm_batched(a, a, stream_budget=int(budget),
                                  as_scipy=True, method=method)
    sync(dev)
    wall1 = time.perf_counter() - t0
    peak1 = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    rss1 = rss_bytes()
    plan = batched._cached_plan(a, a, int(budget), method)  # a cache hit
    nnz_c = int(c_sp.nnz)
    gflops1 = flops / wall1 / 1e9
    say(f"  plan: method {plan.method}, {len(plan.blocks)} blocks of <= "
        f"{int(budget):,} products, grouped fell back to chunked: "
        f"{'yes' if plan.fell_back else 'no'}")
    plan_s = sum(plan.stage_s.values())
    say(f"  plan host time {plan_s:.1f} s "
        f"({100 * plan_s / wall1:.1f}% of the first call): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in plan.stage_s.items()))
    say(f"C = A@A (first call, plan built, C on the host): nnz_c={nnz_c:,} "
        f"in {wall1:.1f} s = {gflops1:.4f} GFlops (wall)")
    if peak1 is not None:
        say(f"  device peak above the start (first call): "
            f"{gib(peak1):.3f} GiB")
    graph_info = graphs.info()
    pool = graph_info["pool_bytes"]
    if cuda:
        say(f"  graphs: {graph_info['captures']} capture(s) for "
            f"{len(plan.blocks)} blocks (ops/graphs); pool {gib(pool):.3f} "
            "GiB, allocated in the capture, so inside the first call's peak")
    say(f"  host peak RSS after the first call: {gib(rss1):.2f} GiB")

    # second call: the plan cached, C left on the device
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    c2 = batched.spgemm_batched(a, a, stream_budget=int(budget),
                                as_scipy=False, method=method)
    if cuda:
        end.record()
    sync(dev)
    wall2 = time.perf_counter() - t0
    dev2_s = start.elapsed_time(end) / 1e3 if cuda else None
    peak2 = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    nnz_c2 = int(c2.rowptr[-1])
    del c2
    say(f"C = A@A (second call, plan cached, C on the device): wall "
        f"{wall2:.3f} s = {flops / wall2 / 1e9:.4f} GFlops; device "
        + (f"{dev2_s:.3f} s = {flops / dev2_s / 1e9:.4f} GFlops (CUDA "
           f"events); device peak above the start {gib(peak2):.3f} GiB, "
           f"beside the graph pool's {gib(pool):.3f} GiB, which a replay "
           "does not allocate"
           if cuda else "time not measured (no card)"))
    if nnz_c2 != nnz_c:
        raise AssertionError(f"the second call's nnz_c {nnz_c2} != {nnz_c}")

    at_reference = (m, min_deg(nnz, m)) == (REFERENCE["m"],
                                            REFERENCE["min_deg"])
    for key, got in (("nnz_a", int(a_sp.nnz)), ("nnz_c", nnz_c)):
        say(f"  {key} {got:,} "
            + (f"beside the reference's {REFERENCE[key]:,} (results.jsonl:65"
               f"): {'equal' if got == REFERENCE[key] else 'DIFFERENT'}"
               if at_reference else "(no reference record at this size)"))

    t0 = time.perf_counter()
    rows = np.sort(np.random.default_rng(0).choice(m, size=check_sample,
                                                   replace=False))
    ok_a, detail_a = sampled_check(a_sp, c_sp, rows)
    say(f"check (a), sampled rows: {'PASS' if ok_a else 'FAIL'}: {detail_a}")
    ok_b, detail_b = vector_check(a_sp, c_sp, products)
    say(f"check (b), y = C x against A (A x): {'PASS' if ok_b else 'FAIL'}: "
        f"{detail_b}")
    check_s = time.perf_counter() - t0
    rss = rss_bytes()
    say(f"  checks took {check_s:.1f} s (host); host peak RSS {gib(rss):.2f} "
        "GiB")
    record = {
        "config": "large-scale-free-batched-1chip", "device": str(dev),
        "card": card, "m": m, "nnz_target": int(nnz), "budget": int(budget),
        "nnz_a": int(a_sp.nnz), "products": total, "flops": flops,
        "nnz_c": nnz_c, "method": plan.method, "blocks": len(plan.blocks),
        "fell_back": plan.fell_back, "gen_s": gen_s, "upload_s": upload_s,
        "plan_s": plan_s, "plan_stage_s": plan.stage_s, "wall_s": wall1,
        "gflops": gflops1,
        "wall2_s": wall2, "device2_s": dev2_s,
        "gflops2": flops / dev2_s / 1e9 if dev2_s else None,
        "gflops2_wall": flops / wall2 / 1e9,
        "device_peak_bytes": peak1, "device_peak2_bytes": peak2,
        "graph_captures": graph_info["captures"], "graph_pool_bytes": pool,
        "host_rss_first_call_bytes": rss1, "host_rss_bytes": rss,
        "check_s": check_s, "check_sample": check_sample,
        "verified_sampled": ok_a, "verified_vector": ok_b,
        "ok": ok_a and ok_b,
    }
    return Demo(record=record, a=a_sp, c=c_sp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m benchmark_spgemm_using_csr_tpu_torch.scripts."
             "demo_large",
        description="C = A @ A out of core on a 77M-nnz scale-free "
                    "matrix, checked two ways; exits 1 if a check fails.")
    ap.add_argument("--nnz", type=float, default=DEFAULT_NNZ,
                    help="target nonzeros of A (sets its shortest row)")
    ap.add_argument("--budget", type=float, default=32e6,
                    help="product-stream budget per row block")
    ap.add_argument("--check-sample", type=int, default=512,
                    help="verify this many random rows against scipy")
    ap.add_argument("--m", type=int, default=DEFAULT_M,
                    help="rows (and columns) of A; small on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card must be there) or cpu")
    ap.add_argument("--results", default=DEFAULT_RESULTS,
                    help="JSON-lines file the run's row is appended to")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (--device cpu runs on the host)")
    logging.basicConfig(level=logging.INFO)
    demo = run(args.nnz, args.budget, args.check_sample, device=args.device,
               m=args.m)
    write_result(args.results, demo.record)
    print(f"demo_large: {'PASS' if demo.record['ok'] else 'FAIL'}")
    return 0 if demo.record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
