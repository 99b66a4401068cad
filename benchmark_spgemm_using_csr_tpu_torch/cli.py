"""Benchmark command line: one sparse operation on one matrix, timed and
checked.

Contract (the reference package's CLI, ``benchmark_spgemm_using_csr_tpu``):

- argv: a ``.mtx`` path (symmetric storage expanded, pattern values
  synthesized), a ``suite:<name>`` synthetic matrix from
  ``utils.generators.SUITE``, or ``gen:<kind>:<size>``;
- ``--op spgemm`` (default): B := A; warmup run(s), then N timed runs of
  ``spgemm(A, A)``; ``spmv`` / ``spmm`` (y = A @ x, Y = A @ X with
  ``--spmm-k`` columns), ``spadd`` (A + A^T) and ``sptrsv`` (L x = b on
  tril(A) with a diagonal shift, level-scheduled) the same way;
- correctness check against the scipy golden;
- prints m, n, nnzA, intermediate products (nnzCt), nnzC, time, GFlops
  (= 2*nnzCt/time) and nnz/s, or one JSON line with ``--json``; ``--out``
  appends the record to a JSON-lines file.

``--device`` (default cuda) names the device; when it is cuda and no CUDA
device exists the run fails instead of using the CPU.

``--mesh N`` runs C = A @ A over N ranks through ``parallel.dist.dist_spgemm``
with ``--schedule`` replicated, ring or halo (``--ring-hop`` for the ring):
N ranks are spawned on this host (``parallel/launch``), rank r on cuda:r
over NCCL with ``--device cuda`` (N cards needed: fewer is an error, never a
fall back to the CPU), on the CPU over gloo with ``--device cpu``. Under
``--multihost`` this process is one rank of a job launched elsewhere
(``parallel/bootstrap``: ``--coordinator``/``--num-processes``/
``--process-id``, their environment variables or torchrun's). Rank 0 writes
the record, with method ``dist/<schedule>x<N>``.

``--dtype bfloat16`` rounds A's values to bfloat16 and verifies at rtol
2e-2 / atol 1e-2 against scipy's float32 product of the rounded values.
``--roofline`` adds the speed-of-light report (``utils/roofline``) of the
method that ran (``auto`` resolved to the dispatcher's pick): its stages,
``_total`` and ``_bound``, priced at the card's data sheet (on the CPU,
the H100 SXM's), with shares of the mean whole-call time only on a CUDA
device.

Usage: python -m benchmark_spgemm_using_csr_tpu_torch suite:er_medium --json
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

METHODS = ["auto", "chunked", "grouped", "tilepack", "bsr", "dia", "dense",
           "tiled", "fused", "esc", "binned", "hash"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="benchmark_spgemm_using_csr_tpu_torch",
        description="CSR SpGEMM benchmark (C = A @ A) with PyTorch/CUDA",
    )
    p.add_argument(
        "matrix",
        help=".mtx file path, or suite:<name> synthetic "
        "(see utils.generators.SUITE), or gen:<kind>:<size> "
        "(kinds: poisson2d, er, powerlaw, banded)",
    )
    p.add_argument(
        "--op", default="spgemm",
        choices=["spgemm", "spmv", "spmm", "spadd", "sptrsv"],
        help="benchmarked operation (spgemm: C=A@A; spmv: y=A@x; "
        "spmm: Y=A@X with k=--spmm-k dense columns; "
        "spadd: C=A+A^T symmetrization; "
        "sptrsv: L x = b on tril(A) with a diagonal shift ensuring "
        "nonsingularity, level-scheduled exact solve)",
    )
    p.add_argument("--spmm-k", type=int, default=64)
    p.add_argument("--method", default="auto", choices=METHODS)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument(
        "--dtype", default="float32",
        choices=["float32", "bfloat16", "float64"],
        help="value type; float64 verifies at rtol 1e-12 against the x64 "
        "scipy golden, bfloat16 at rtol 2e-2 against the float32 golden of "
        "the rounded values",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip scipy golden check")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of text")
    p.add_argument("--roofline", action="store_true",
                   help="per-stage speed-of-light report of the method that "
                   "ran, with the whole product's bound (_bound)")
    p.add_argument("--out", default=None,
                   help="append a JSONL record to this path")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run distributed over an N-rank mesh, one device a "
                   "rank (0 = single device)")
    p.add_argument("--schedule", default="replicated",
                   choices=["replicated", "ring", "halo"],
                   help="distributed schedule (with --mesh)")
    p.add_argument("--ring-hop", type=int, default=None, metavar="H",
                   help="ring schedule: B blocks per resident super-buffer "
                   "(must divide the mesh size; default P//4 at P>=8)")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a job launched "
                   "elsewhere: join it (torch.distributed) before building "
                   "the mesh; topology from --coordinator/--num-processes/"
                   "--process-id, COORDINATOR_ADDRESS/NUM_PROCESSES/"
                   "PROCESS_ID or torchrun's MASTER_ADDR/WORLD_SIZE/RANK "
                   "(see parallel/bootstrap.py)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def load_matrix(spec: str, dtype):
    """Resolve a matrix spec: a .mtx path, suite:<name>, or gen:<kind>:<n>."""
    from .utils import generators
    from .utils.mtx import read_mtx

    if spec.startswith("suite:"):
        name = spec[len("suite:"):]
        if name not in generators.SUITE:
            raise SystemExit(
                f"unknown suite matrix {name!r}; have {sorted(generators.SUITE)}"
            )
        return generators.SUITE[name]().astype(dtype)
    if spec.startswith("gen:"):
        _, kind, size = spec.split(":", 2)
        n = int(size)
        if kind == "poisson2d":
            return generators.poisson2d(n, dtype=dtype)
        if kind == "er":
            return generators.erdos_renyi(n, n, 8.0, dtype=dtype)
        if kind == "powerlaw":
            return generators.power_law(n, n, alpha=2.0,
                                        max_deg=max(n // 16, 2), dtype=dtype)
        if kind == "banded":
            return generators.banded(n, bandwidth=12, dtype=dtype)
        raise SystemExit(f"unknown generator kind {kind!r}")
    return read_mtx(spec, dtype=dtype)


def _device(spec: str):
    import torch

    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {spec}: no CUDA device is available")
    return device


# a --mesh group's bounds: every rank must finish within the deadline, and
# wait at most the process-group timeout at one collective
MESH_TIMEOUT_S, MESH_PG_TIMEOUT_S = 3600.0, 600.0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    if args.mesh or args.multihost:
        return run_mesh(args, device)
    if args.op == "spgemm":
        return emit_spgemm(args, spgemm_record(args, device))

    import torch

    from . import CSR

    np_dtype = np.float64 if args.dtype == "float64" else np.float32
    a_sp = load_matrix(args.matrix, np_dtype)
    a = CSR.from_scipy(a_sp, dtype=getattr(torch, args.dtype), device=device)
    nnz_a = int(a_sp.nnz)

    if args.op in ("spmv", "spmm"):
        return run_spmv_spmm(args, device, a, a_sp, nnz_a)
    if args.op == "spadd":
        return run_spadd(args, device, a, a_sp, nnz_a)
    return run_sptrsv(args, device, a_sp)


def spgemm_record(args, device, mesh=None) -> dict:
    """Load A, time C = A @ A (on ``mesh``, every rank taking part, when
    given), verify against scipy (only rank 0 of a mesh) and return the
    record."""
    import torch

    from . import CSR, spgemm, spgemm_flops
    from .utils.oracle import TOLERANCES, assert_csr_equal, spgemm_reference
    from .utils.timing import bench

    np_dtype = np.float64 if args.dtype == "float64" else np.float32
    a_sp = load_matrix(args.matrix, np_dtype)
    a = CSR.from_scipy(a_sp, dtype=getattr(torch, args.dtype), device=device)
    m, n = a.shape
    flops = spgemm_flops(a, a)

    if mesh is None:
        run = lambda: spgemm(a, a, method=args.method, trim=False)  # noqa: E731
    else:
        from .parallel.dist import dist_spgemm

        run = lambda: dist_spgemm(  # noqa: E731
            a, a, mesh, schedule=args.schedule, ring_hop=args.ring_hop)
    c = run()
    nnz_c = int(c.rowptr[-1])
    res = bench(run, device=device, name=args.matrix, warmup=args.warmup,
                runs=args.runs, flops=flops, nnz_out=nnz_c)

    verified = None
    if not args.no_verify and (mesh is None or mesh.rank == 0):
        a_host = a.to_scipy()
        golden = spgemm_reference(a_host, a_host)
        try:
            # scipy drops sums that cancel to exactly 0, which bfloat16's
            # 8-bit mantissas make common, and C keeps them: bfloat16
            # compares the structures with exact zeros pruned on both sides.
            # A sum that cancels in one order of addition and not in the
            # other may lie in one structure within its rounding bound.
            assert_csr_equal(c, golden,
                             check_explicit_zeros=args.dtype != "bfloat16",
                             factors=(a_host, a_host),
                             **TOLERANCES[args.dtype])
            verified = True
        except AssertionError as e:
            verified = False
            print(f"VERIFY FAILED: {e}", file=sys.stderr)

    record = {
        "matrix": args.matrix,
        "method": (args.method if mesh is None
                   else f"dist/{args.schedule}x{mesh.size}"),
        "dtype": args.dtype,
        "device": res.device,
        "m": m,
        "n": n,
        "nnz_a": int(a_sp.nnz),
        "nnz_ct": int(flops // 2),
        "nnz_c": nnz_c,
        "mean_s": res.mean_s,
        "min_s": res.min_s,
        "gflops": res.gflops,
        "gflops_best": res.gflops_best,
        "nnz_per_s": res.nnz_per_s,
        "verified": verified,
    }
    if args.roofline:
        record.update(roofline_record(args, device, a, c, res))
    return record


def emit_spgemm(args, record: dict) -> int:
    """Write the SpGEMM record (JSON or text) and return the exit code."""
    verified = record["verified"]
    if _emit(args, record):
        print(f"matrix     : {args.matrix}  ({record['m']} x {record['n']}, "
              f"nnzA = {record['nnz_a']})")
        print(f"method     : {record['method']}  dtype={args.dtype}  "
              f"device={record['device']}")
        print(f"nnzCt      : {record['nnz_ct']}  (intermediate products; "
              f"flops = {2 * record['nnz_ct']})")
        print(f"nnzC       : {record['nnz_c']}")
        print(f"time       : mean {record['mean_s'] * 1e3:.3f} ms   best "
              f"{record['min_s'] * 1e3:.3f} ms  ({args.runs} runs)")
        print(f"GFlops     : mean {record['gflops']:.4f}   best "
              f"{record['gflops_best']:.4f}")
        print(f"nnz/s      : {record['nnz_per_s']:.3e}")
        if verified is not None:
            print(f"verify     : {'PASS' if verified else 'FAIL'} (vs scipy golden)")
        if args.roofline:
            print(f"roofline   : {record['roofline_method']}")
            print(json.dumps(record["roofline"], indent=2))
    return 0 if verified in (True, None) else 1


def _mesh_rank(mesh, argv) -> dict:
    """One spawned rank of ``--mesh``: the SpGEMM run on its device."""
    args = build_parser().parse_args(argv)
    return spgemm_record(args, mesh.device, mesh)


def run_mesh(args, device) -> int:
    """``--mesh N``: spawn N ranks here, or (``--multihost``) join a job
    as one rank. Rank 0's record is written."""
    if args.op != "spgemm":
        raise SystemExit(f"--mesh runs --op spgemm, not {args.op}")
    if args.roofline:
        raise SystemExit("--roofline prices a single-device method; "
                         "it does not take --mesh")
    if args.multihost:
        from .parallel.bootstrap import global_mesh, init_multihost, shutdown

        topo = init_multihost(args.coordinator, args.num_processes,
                              args.process_id, device=device.type)
        print(f"multihost  : process {topo.process_id}/{topo.process_count}"
              f" over {topo.backend} on {topo.device}", file=sys.stderr)
        try:
            mesh = global_mesh(args.mesh or None)
            record = (None if mesh is None
                      else spgemm_record(args, mesh.device, mesh))
        finally:
            shutdown()
        if mesh is None or mesh.rank != 0:
            return 0  # rank 0 verifies and writes the record
        return emit_spgemm(args, record)

    if args.mesh < 1:
        raise SystemExit(f"--mesh {args.mesh}: needs at least one rank")
    if device.type == "cuda":
        import torch

        have = torch.cuda.device_count()
        if args.mesh > have:
            raise SystemExit(f"need {args.mesh} devices, have {have}")
    from .parallel.launch import spawn

    argv = [args.matrix, "--dtype", args.dtype, "--runs", str(args.runs),
            "--warmup", str(args.warmup), "--schedule", args.schedule]
    if args.ring_hop is not None:
        argv += ["--ring-hop", str(args.ring_hop)]
    if args.no_verify:
        argv.append("--no-verify")
    record = spawn(_mesh_rank, args.mesh, argv, device=device.type,
                   timeout_s=MESH_TIMEOUT_S,
                   pg_timeout_s=MESH_PG_TIMEOUT_S)[0]
    return emit_spgemm(args, record)


def roofline_record(args, device, a, c, res) -> dict:
    """The roofline report of the method that ran (``auto``: the
    dispatcher's pick) against the mean whole-call time."""
    from .ops.dispatch import choose_method
    from .utils.roofline import roofline_report, spgemm_models

    method = choose_method(a, a) if args.method == "auto" else args.method
    models, bound = spgemm_models(a, a, c, method)
    return {"roofline_method": method,
            "roofline": roofline_report(models, total_time_s=res.mean_s,
                                        bound=bound, measured_on=device)}


def _emit(args, record: dict) -> bool:
    """Append the record to ``--out`` and print it as JSON with ``--json``;
    True when the caller prints the text form instead."""
    if args.out:
        from .utils.results import write_result

        write_result(args.out, record)
    if args.json:
        print(json.dumps(record))
        return False
    return True


def _finish(args, record: dict, extra: str = "") -> int:
    """Emit an op's record (text: one line) and return the exit code."""
    verified = record["verified"]
    if _emit(args, record):
        state = "PASS" if verified else ("skip" if verified is None else "FAIL")
        print(f"{args.op}: {args.matrix}{extra} mean "
              f"{record['mean_s'] * 1e3:.3f} ms  {record['gflops']:.4f} "
              f"GFlops  verify {state}")
    return 0 if verified in (True, None) else 1


def _op_record(args, res, m: int, n: int, **extra) -> dict:
    return {"matrix": args.matrix, "op": args.op, "device": res.device,
            "m": m, "n": n, **extra, "mean_s": res.mean_s,
            "min_s": res.min_s, "gflops": res.gflops}


def run_spmv_spmm(args, device, a, a_sp, nnz_a: int) -> int:
    """y = A @ x (spmv) or Y = A @ X (spmm) against the scipy golden; x is
    float32 from seed 0."""
    import torch

    from .ops.spmv import spmm as spmm_op, spmv as spmv_op
    from .utils.timing import bench

    m, n = a.shape
    rng = np.random.default_rng(0)
    if args.op == "spmv":
        x_np = rng.standard_normal(n).astype(np.float32)
        op, flops = spmv_op, 2 * nnz_a
    else:
        x_np = rng.standard_normal((n, args.spmm_k)).astype(np.float32)
        op, flops = spmm_op, 2 * nnz_a * args.spmm_k
    x = torch.from_numpy(x_np).to(device)
    run = lambda: op(a, x)  # noqa: E731
    res = bench(run, device=device, name=args.matrix, warmup=args.warmup,
                runs=args.runs, flops=flops)
    verified = None
    if not args.no_verify:
        got = run().cpu().numpy()
        verified = bool(np.allclose(got, a_sp @ x_np, rtol=1e-3, atol=1e-3))
        if not verified:
            print("VERIFY FAILED (spmv/spmm)", file=sys.stderr)
    record = _op_record(args, res, m, n, nnz_a=nnz_a)
    return _finish(args, dict(record, verified=verified))


def run_spadd(args, device, a, a_sp, nnz_a: int) -> int:
    """C = A + A^T (symmetrization) against the scipy golden."""
    from .ops.spadd import make_add_plan, spadd_planned
    from .sparse.csr import csr_transpose
    from .utils.oracle import assert_csr_equal
    from .utils.timing import bench

    m, n = a.shape
    if m != n:
        raise SystemExit("spadd demo (A + A^T) needs a square matrix")
    at = csr_transpose(a)
    plan = make_add_plan(a, at)
    run = lambda: spadd_planned(a, at, plan)  # noqa: E731
    res = bench(run, device=device, name=args.matrix, warmup=args.warmup,
                runs=args.runs, flops=nnz_a * 2)  # one add per stream slot
    verified = None
    if not args.no_verify:
        try:
            assert_csr_equal(run(), (a_sp + a_sp.T).tocsr(), rtol=1e-3,
                             atol=1e-3)
            verified = True
        except AssertionError:
            verified = False
            print("VERIFY FAILED (spadd)", file=sys.stderr)
    record = _op_record(args, res, m, n, nnz_a=nnz_a)
    return _finish(args, dict(record, verified=verified))


def run_sptrsv(args, device, a_sp) -> int:
    """The exact level-scheduled solve L x = b, L = tril(A) in float32 with
    the diagonal shifted for nonsingularity (row-sum dominance), against
    scipy.sparse.linalg.spsolve_triangular."""
    import scipy.sparse as sp
    import torch

    from . import CSR
    from .ops.sptrsv import make_trsv_plan, sptrsv_planned
    from .utils.timing import bench

    m, n = a_sp.shape
    if m != n:
        raise SystemExit("sptrsv needs a square matrix")
    l_sp = sp.tril(a_sp.tocsr(), format="csr").astype(np.float32)
    shift = np.abs(l_sp).sum(axis=1).max() + 1.0
    l_sp = (l_sp + sp.identity(m, np.float32, format="csr") * shift).tocsr()
    nnz_l = l_sp.nnz
    a = CSR.from_scipy(l_sp, device=device)
    sched = make_trsv_plan(a, lower=True)
    b_np = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    b = torch.from_numpy(b_np).to(device)
    run = lambda: sptrsv_planned(a, b, sched)  # noqa: E731
    res = bench(run, device=device, name=args.matrix, warmup=args.warmup,
                runs=args.runs, flops=2 * nnz_l)
    verified = None
    if not args.no_verify:
        from scipy.sparse.linalg import spsolve_triangular

        want = spsolve_triangular(l_sp, b_np, lower=True)
        verified = bool(np.allclose(run().cpu().numpy(), want, rtol=1e-3,
                                    atol=1e-3))
        if not verified:
            print("VERIFY FAILED (sptrsv)", file=sys.stderr)
    record = _op_record(args, res, m, n, nnz_l=nnz_l,
                        n_levels=sched.plan.n_levels,
                        n_steps=sched.plan.n_steps)
    return _finish(args, dict(record, verified=verified),
                   f" ({m} rows, nnzL {nnz_l}, {sched.plan.n_levels} levels, "
                   f"{sched.plan.n_steps} steps)")


if __name__ == "__main__":
    sys.exit(main())
