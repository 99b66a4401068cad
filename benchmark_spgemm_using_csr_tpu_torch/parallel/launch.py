"""Spawn a mesh of ranks on this host, and the distributed dry run.

The reference drives every device of its mesh from one process. Under
torch.distributed one process is one rank, so the CLI's ``--mesh N``, the
dry run and the tests start N ranks here: ``spawn`` runs ``fn(mesh,
*args)`` in each (start method ``spawn``, a free localhost port, NCCL on
CUDA devices, gloo on the CPU), bounds the process group's collectives by
``pg_timeout_s`` and the whole group by a deadline, kills every rank that
outlives it, and raises on any rank's failure.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import torch


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, pg_timeout_s, fn, args, results):
    """One rank: join the group, run ``fn(mesh, *args)``, report."""
    import torch.distributed as dist

    from .mesh import make_mesh

    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            dev = torch.device("cpu")
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout_s),
        )
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, nprocs: int, *args, device: str, timeout_s: float = 120.0,
          pg_timeout_s: float = 60.0) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` new ranks and return their
    results in rank order. ``fn`` and its arguments travel by pickle (a
    module-level function). device "cuda" puts rank r on cuda:r over NCCL
    and needs nprocs cards; "cpu" runs gloo. Every rank is killed and
    RuntimeError raised when one fails or the group passes ``timeout_s``."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda" and nprocs > torch.cuda.device_count():
        raise RuntimeError(f"need {nprocs} devices, have "
                           f"{torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, port, device, pg_timeout_s, fn,
                               args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failed = {}, None
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        while len(got) < nprocs and failed is None:
            if time.monotonic() > deadline:
                failed = f"the group passed its {timeout_s:.0f} s deadline"
                break
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failed = (f"rank {dead[0]} exited with code "
                              f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                got[rank] = out
            else:
                failed = f"rank {rank} failed:\n{out}"
        if failed is not None:
            # a failure stops its peers too: report what they send soon
            stop = time.monotonic() + 2.0
            while time.monotonic() < stop:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if not ok:
                    failed += f"\nrank {rank} failed:\n{out}"
        else:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    if failed is not None:
        raise RuntimeError(f"spawn({nprocs} ranks): {failed}")
    return [got[r] for r in range(nprocs)]


def _dryrun_rank(mesh, m: int) -> str:
    """One rank of the dry run: every schedule against scipy."""
    from ..sparse.csr import CSR
    from ..utils import generators
    from ..utils.oracle import assert_csr_equal, spgemm_reference
    from .dist import dist_spgemm

    a = CSR.from_scipy(
        generators.power_law(m, m, alpha=1.8, max_deg=m // 4, seed=1),
        device=mesh.device)
    golden = spgemm_reference(a, a)
    for schedule in ("replicated", "ring", "halo"):
        assert_csr_equal(dist_spgemm(a, a, mesh, schedule=schedule), golden,
                         rtol=1e-4, atol=1e-5)
    return (f"dryrun_multichip({mesh.size}): replicated + ring + halo "
            f"schedules OK on skewed power-law ({m} rows, nnz "
            f"{int(a.rowptr[-1])}) over {mesh.backend}")


def dryrun_multichip(n: int, *, device: str) -> str:
    """The reference's distributed dry run on ``n`` spawned ranks on
    ``device`` ("cuda": one card each over NCCL; "cpu": gloo): a skewed
    power-law matrix (m = max(128 n, 512), alpha 1.8, max_deg m // 4, seed
    1) through the replicated, ring and halo schedules, each against
    scipy, within a 300 s deadline. Returns rank 0's line."""
    return spawn(_dryrun_rank, n, max(128 * n, 512), device=device,
                 timeout_s=300.0)[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m benchmark_spgemm_using_csr_tpu_torch.parallel.launch",
        description="The distributed dry run on N spawned ranks.")
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one card per rank over NCCL; cpu: gloo")
    args = ap.parse_args(argv)
    if args.device == "cuda" and args.n > torch.cuda.device_count():
        raise SystemExit(f"need {args.n} devices, have "
                         f"{torch.cuda.device_count()}")
    print(dryrun_multichip(args.n, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
