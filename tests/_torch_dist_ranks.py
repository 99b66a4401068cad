"""The rank side of the port's distributed tests: spawned gloo ranks run
every case of a test module once, and rank 0 of each case's mesh writes the
whole C to ``out_dir/<case>.npz``; the test module compares the files with
the JAX package and scipy (``spawn_cases_once``, ``read_c``). Imports
torch and the port only, so a rank starts without jax.

A case is a dict: ``name``, ``p`` (mesh size), ``kind``, ``a``/``b`` (the
npz files of the operands) and the options of its kind.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.parallel import dist as D
from benchmark_spgemm_using_csr_tpu_torch.parallel import halo as H
from benchmark_spgemm_using_csr_tpu_torch.parallel.launch import spawn
from benchmark_spgemm_using_csr_tpu_torch.parallel.mesh import make_mesh
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR, host_view

MESH_SIZES = (2, 4, 8)
# a spawned group's bounds: its collectives, and the whole group
PG_TIMEOUT_S, GROUP_TIMEOUT_S = 60, 120


def load(path: str, dtype: str = "float32") -> CSR:
    with np.load(path) as z:
        return CSR.from_numpy(z["rowptr"], z["colidx"], z["vals"],
                              tuple(int(s) for s in z["shape"]),
                              device="cpu", dtype=getattr(torch, dtype))


def whole(c_loc: CSR, mesh, shape, bounds) -> CSR:
    return D.unshard(D.gather_shards(c_loc, mesh, shape, bounds))


def run_case(case: dict, mesh) -> tuple[CSR, str]:
    """C of one case on this rank, and a note (the plan type it ran)."""
    p, kind = case["p"], case["kind"]
    a = load(case["a"], case.get("dtype", "float32"))
    b = a if case["b"] == case["a"] else load(case["b"],
                                               case.get("dtype", "float32"))
    shape = (a.m, b.n)
    bounds = D.balanced_row_bounds(a, b, p) if case.get("balanced") else None
    if kind == "dist_spgemm":
        plan = D.dist_plan(a, b, p, case["schedule"], case.get("hop"))
        c = D.dist_spgemm(a, b, mesh, schedule=case["schedule"],
                          ring_hop=case.get("hop"))
        return c, type(plan).__name__
    if kind == "replicated":
        a_sh = D.shard_rows(a, p, bounds=bounds)
        if case.get("grouped"):
            gp = D.make_dist_grouped_plan(a, b, p, bounds=bounds)
            c_loc = D.dist_spgemm_replicated(a_sh, b, mesh, grouped_plan=gp)
        else:
            lp = D.make_dist_local_plan(a, b, p, bounds=bounds)
            c_loc = D.dist_spgemm_replicated(a_sh, b, mesh, plan=lp)
        return whole(c_loc, mesh, shape, a_sh.bounds), kind
    if kind == "ring":
        rplan = D.make_ring_plan(a, b, p, bounds=bounds, hop=case["hop"])
        c_loc = D.dist_spgemm_ring(D.shard_rows(a, p, bounds=bounds),
                                   D.shard_rows(b, p), mesh, ring_plan=rplan)
        return whole(c_loc, mesh, shape, rplan.bounds), kind
    if kind == "halo":
        hplan = H.build_halo_plan(a, b, p, bounds=bounds)
        c_loc = H.dist_spgemm_halo(hplan, D.shard_rows(a, p, bounds=bounds),
                                   D.shard_rows(b, p), mesh)
        return whole(c_loc, mesh, shape, hplan.bounds), kind
    if kind == "revalue":
        # a first call fills the memos; then A = B gets new values, in a
        # new tensor beside the same index tensors or written in place
        D.dist_spgemm(a, a, mesh, schedule=case["schedule"])
        if case["how"] == "new":
            a = CSR(a.rowptr, a.colidx, a.vals * case["scale"], a.shape)
        else:
            a.vals.mul_(case["scale"])
        return D.dist_spgemm(a, a, mesh, schedule=case["schedule"]), kind
    if kind == "spgemm_halo":
        return H.spgemm_halo(a, b, mesh), kind
    if kind == "spadd":
        return D.dist_spadd(a, b, mesh, alpha=case.get("alpha", 1.0),
                            beta=case.get("beta", 1.0)), kind
    raise ValueError(f"unknown kind {kind!r}")


def backend_mismatch_raises(mesh) -> bool:
    """A tensor off the CPU cannot travel on gloo (a meta tensor stands in
    for a CUDA one)."""
    t = torch.empty(4, device="meta")
    for call in (lambda: mesh.ring_shift(t, 1),
                 lambda: mesh.all_to_all_v(t, [4] + [0] * (mesh.size - 1),
                                           [4] + [0] * (mesh.size - 1)),
                 lambda: mesh.all_gather_v(t, [4] * mesh.size)):
        try:
            call()
        except ValueError:
            continue
        return False
    return True


def run_cases(mesh, cases_path: str, out_dir: str) -> int:
    """Every case, each on the mesh of its size (ranks outside it skip);
    returns the number this rank took part in."""
    with open(cases_path) as f:
        cases = json.load(f)
    meshes = {mesh.size: mesh}
    for p in MESH_SIZES:  # every rank builds every subgroup, in one order
        if p < mesh.size:
            meshes[p] = make_mesh(p, device="cpu")
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "_mesh.json"), "w") as f:
            json.dump({"backend": mesh.backend,
                       "mismatch_raises": backend_mismatch_raises(mesh)}, f)
    done = 0
    for case in cases:
        sub = meshes[case["p"]]
        if sub is None:
            continue
        c, note = run_case(case, sub)
        done += 1
        if sub.rank == 0:
            nnz = int(c.rowptr[-1])
            np.savez(os.path.join(out_dir, case["name"] + ".npz"),
                     rowptr=host_view(c.rowptr),
                     colidx=host_view(c.colidx)[:nnz],
                     vals=host_view(c.vals)[:nnz], shape=np.asarray(c.shape),
                     note=np.asarray(note), dtype=np.asarray(str(c.dtype)))
    return done


def spawn_cases(cases, matrices, d):
    """Write every case's operands (``matrices[name]()``, scipy) under the
    directory ``d``, spawn 8 gloo ranks that run the cases once, and
    return the directory of their outputs."""
    d = str(d)
    todo = []
    for c in sorted(cases, key=lambda c: c["p"]):
        c = dict(c)
        np_dtype = np.float64 if c.get("dtype") == "float64" else np.float32
        for side in ("a", "b"):
            path = os.path.join(d, f"{c[side]}_{np_dtype.__name__}.npz")
            if not os.path.exists(path):
                t = T.CSR.from_scipy(matrices[c[side]]().astype(np_dtype),
                                     device="cpu")
                np.savez(path, rowptr=t.rowptr.numpy(),
                         colidx=t.colidx.numpy(), vals=t.vals.numpy(),
                         shape=np.asarray(t.shape))
            c[side] = path
        todo.append(c)
    cases_path = os.path.join(d, "cases.json")
    with open(cases_path, "w") as f:
        json.dump(todo, f)
    out = os.path.join(d, "out")
    os.mkdir(out)
    done = spawn(run_cases, max(MESH_SIZES), cases_path, out, device="cpu",
                 timeout_s=GROUP_TIMEOUT_S, pg_timeout_s=PG_TIMEOUT_S)
    if done[0] != len(todo):
        raise AssertionError(f"rank 0 ran {done[0]} of {len(todo)} cases")
    return out


def spawn_cases_once(cases, matrices, tmp_path_factory, name: str) -> str:
    """``spawn_cases`` once per test session for the module ``name``.
    Under pytest-xdist every worker that runs one of the module's tests
    asks for the outputs: the first to create the shared directory (an
    atomic mkdir in the session's base temp) spawns the group, the others
    wait for its marker, so one group of ranks runs at a time per module."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return spawn_cases(cases, matrices, tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent / f"spawned_{name}"
    marker = root / "status"
    try:
        root.mkdir()
    except FileExistsError:
        # the spawning worker also writes the operands first
        deadline = time.monotonic() + GROUP_TIMEOUT_S + 180
        while not marker.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no outputs in {root} after "
                                   f"{GROUP_TIMEOUT_S + 180} s")
            time.sleep(0.5)
        status = marker.read_text()
        if status != "ok":
            raise RuntimeError(f"the worker that spawned the ranks failed:\n"
                               f"{status}")
        return str(root / "work" / "out")
    (root / "work").mkdir()
    try:
        out = spawn_cases(cases, matrices, root / "work")
        status = "ok"
    except BaseException as e:
        status = f"{type(e).__name__}: {e}"
        raise
    finally:
        tmp = root / "status.tmp"
        tmp.write_text(status)
        os.replace(tmp, marker)  # the waiters see it whole
    return out


def read_c(out: str, name: str):
    """(C, note, nnz) that rank 0 wrote for a case."""
    with np.load(os.path.join(out, f"{name}.npz")) as z:
        c = T.CSR.from_numpy(z["rowptr"], z["colidx"], z["vals"],
                             tuple(int(s) for s in z["shape"]), device="cpu")
        return c, str(z["note"]), int(z["rowptr"][-1])


def sleep_rank(mesh, seconds: float) -> None:
    """A rank that outlives any short deadline."""
    import time

    time.sleep(seconds)


def fail_rank(mesh) -> None:
    """Rank 1 fails; the others wait at a collective it never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    torch.distributed.barrier()
