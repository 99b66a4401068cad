"""The five BASELINE.json acceptance configs end to end, each held against
scipy, after the reference's ``scripts/acceptance.py``.

    python -m benchmark_spgemm_using_csr_tpu_torch.scripts.acceptance
        [--small] [--device cuda|cpu] [--results bench_out/results_torch.jsonl]

1. FEM regime (poisson2d) in float64 through chunked, against scipy at
   rtol/atol 1e-12, natively on ``--device`` (the reference ran it on the
   CPU because the TPU has no float64);
2. short irregular rows (Erdos-Renyi, 6 a row) through a chunked plan;
3. the AMG Galerkin R·A·P hierarchy on 2D Poisson and its V-cycle solve:
   the solver's residual history and the true residual of its x, computed
   by scipy in float64;
4. long power-law rows through the hash path;
5. the row-partitioned distributed product, halo and ring schedules: 8
   gloo ranks on the CPU, as the reference's 8-device CPU mesh; on the
   card also torch.cuda.device_count() ranks over NCCL, one card each.

Configs 1-4 run on ``--device`` (the card by default; no fall back to the
CPU). One line a config, ``[PASS]`` or ``[FAIL]``; a config that raises
fails. One row a config goes to ``--results``, never to the reference's
results.jsonl. Exits 1 if any config fails, as the reference does.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..bench import DEFAULT_RESULTS
from ..models import amg
from ..ops.chunked import make_chunked_plan, spgemm_chunked
from ..ops.hash import spgemm_hash
from ..parallel.dist import dist_spgemm
from ..parallel.launch import spawn
from ..sparse.csr import CSR
from ..utils import generators
from ..utils.oracle import assert_csr_equal, spgemm_reference
from ..utils.results import write_result


def config1_f64(small: bool, device) -> str:
    """float64 poisson2d through chunked, against x64 scipy at 1e-12."""
    n = 24 if small else 64
    a = CSR.from_scipy(generators.poisson2d(n).astype(np.float64),
                       device=device)
    c = spgemm_chunked(a, a, make_chunked_plan(a, a))
    if c.vals.dtype != torch.float64:
        raise AssertionError(f"C's values are {c.vals.dtype}, not float64")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-12, atol=1e-12)
    return (f"poisson2d_{n} float64 on {device} (the reference ran it on "
            f"the CPU: the TPU has no float64), nnzC {int(c.rowptr[-1]):,}")


def config2_short_rows(small: bool, device) -> str:
    n = 2048 if small else 16384
    a = CSR.from_scipy(generators.erdos_renyi(n, n, 6.0, seed=2),
                       device=device)
    c = spgemm_chunked(a, a, make_chunked_plan(a, a))
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
    return f"er_{n} chunked on {device}, nnzC {int(c.rowptr[-1]):,}"


def config3_amg(small: bool, device) -> str:
    """The reference's pass mark (the solver's last relative residual
    below 1e-4 ||b||) and the true residual ||b - A x|| / ||b|| of the
    returned x by scipy in float64, below 1e-4."""
    k = 24 if small else 64
    a_sp = generators.poisson2d(k)
    b = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    x, residuals = amg.solve(a_sp, b, tol=1e-5, max_iters=60, device=device)
    bnorm = float(np.linalg.norm(b))
    true = float(np.linalg.norm(b - a_sp.astype(np.float64) @ x) / bnorm)
    if not residuals[-1] < 1e-4 * bnorm:
        raise AssertionError(f"residual {residuals[-1]:.3g} after "
                             f"{len(residuals)} iterations")
    if not true < 1e-4:
        raise AssertionError(f"true residual {true:.3g} (scipy, float64)")
    return (f"poisson2d_{k} on {device}: {len(residuals)} V-cycles, "
            f"residual {residuals[-1]:.3g}, true residual {true:.3g}")


def config4_powerlaw_hash(small: bool, device) -> str:
    n = 1024 if small else 4096
    a = CSR.from_scipy(
        generators.power_law(n, n, alpha=1.9, max_deg=n // 8, seed=4),
        device=device)
    c = spgemm_hash(a, a)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
    return f"powerlaw_{n} hash on {device}, nnzC {int(c.rowptr[-1]):,}"


def dist_rank(mesh, n: int) -> str:
    """One rank of config 5: the halo and ring schedules against scipy."""
    a = CSR.from_scipy(
        generators.power_law(n, n, alpha=2.0, max_deg=n // 8, seed=5),
        device=mesh.device)
    want = spgemm_reference(a, a)
    for schedule in ("halo", "ring"):
        assert_csr_equal(dist_spgemm(a, a, mesh, schedule=schedule), want,
                         rtol=1e-3, atol=1e-3)
    return f"{mesh.size} {mesh.backend} ranks"


def config5_distributed(small: bool, device) -> str:
    n = 512 if small else 2048
    groups = [("cpu", 8)]
    if torch.device(device).type == "cuda":
        groups.append(("cuda", torch.cuda.device_count()))
    done = [spawn(dist_rank, ranks, n, device=where, timeout_s=600.0)[0]
            for where, ranks in groups]
    return f"powerlaw_{n} halo + ring on " + "; on ".join(done)


CONFIGS = (
    ("1-f64-scipy-checked", config1_f64),
    ("2-short-rows-1chip", config2_short_rows),
    ("3-amg-galerkin-vcycle", config3_amg),
    ("4-powerlaw-hash-path", config4_powerlaw_hash),
    ("5-distributed-halo-ring", config5_distributed),
)


def run(small: bool, *, device, results: str, say=print) -> bool:
    """Every config, one line each; True if all passed."""
    ok_all = True
    for name, fn in CONFIGS:
        t0 = time.perf_counter()
        try:
            ok, detail = True, fn(small, device)
        except Exception as e:  # a config that raises fails; go on
            ok, detail = False, f"{type(e).__name__}: {str(e)[:300]}"
        seconds = time.perf_counter() - t0
        say(f"[{'PASS' if ok else 'FAIL'}] {name}  ({seconds:.1f}s)  "
            f"{detail}")
        write_result(results, {"config": f"acceptance/{name}", "ok": ok,
                               "seconds": seconds, "detail": detail,
                               "device": str(device), "small": small})
        ok_all &= ok
    say(f"ACCEPTANCE: {'ALL PASS' if ok_all else 'FAILURES'}")
    return ok_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m benchmark_spgemm_using_csr_tpu_torch.scripts."
             "acceptance",
        description="The five BASELINE acceptance configs, each against "
                    "scipy; exits 1 if any fails.")
    ap.add_argument("--small", action="store_true", help="tiny shapes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card must be there) or cpu")
    ap.add_argument("--results", default=DEFAULT_RESULTS,
                    help="JSON-lines file the configs' rows are appended to")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (--device cpu runs on the host)")
    return 0 if run(args.small, device=device, results=args.results) else 1


if __name__ == "__main__":
    sys.exit(main())
