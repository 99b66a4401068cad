"""The port's halo-exchange schedule (parallel/halo.py: the host halo plan,
two ragged all-to-alls, the local chunked SpGEMM) against the reference
package on the same seeded inputs, the reference's own test matrices
(tests/test_halo.py) and sizes.

``HaloPlan``'s tables equal the reference's element for element (in
process). C: one group of 8 gloo ranks, with meshes of 2 and 4 carved out
of it, runs every case once (``_torch_dist_ranks``); each case holds its C
against the JAX package's C on the ``eight_devices`` virtual mesh
(structure exactly, float32 values within rtol 1e-4 / atol 1e-5) and
against scipy.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.parallel import dist as jdist
from benchmark_spgemm_using_csr_tpu.parallel import halo as jhalo
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen
from benchmark_spgemm_using_csr_tpu.utils.oracle import random_csr

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops.chunked import ChunkedPlan
from benchmark_spgemm_using_csr_tpu_torch.parallel import dist as tdist
from benchmark_spgemm_using_csr_tpu_torch.parallel import halo as thalo
from benchmark_spgemm_using_csr_tpu_torch.parallel.mesh import Mesh as TMesh
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import assert_csr_equal

import _torch_dist_ranks

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def empty_shards():
    """Only the first quarter of the rows (and columns) holds entries."""
    m = 64
    a = sp.lil_matrix((m, m), dtype=np.float32)
    a[: m // 4, : m // 4] = np.random.default_rng(0).random((m // 4, m // 4))
    return a.tocsr()


MATRICES = {
    "er96": lambda: jgen.erdos_renyi(96, 96, 5.0, seed=11),
    "pl128": lambda: jgen.power_law(128, 128, alpha=1.9, max_deg=64, seed=12),
    "rect_a": lambda: random_csr(64, 48, density=0.1, seed=5).to_scipy(),
    "rect_b": lambda: random_csr(48, 72, density=0.12, seed=6).to_scipy(),
    "poisson12": lambda: jgen.poisson2d(12),
    "banded256": lambda: jgen.banded(256, bandwidth=3, seed=2),
    "empty_shards": empty_shards,
    "pl300": lambda: jgen.power_law(300, 300, alpha=1.8, max_deg=128, seed=6),
    "circuit2048": lambda: jgen.circuit(2048, seed=3),  # wide split
    "banded512": lambda: jgen.banded(512, bandwidth=12, seed=2),  # al 16
}


def case(name, p, kind, a, b=None, **opts):
    return dict(name=name, p=p, kind=kind, a=a, b=b or a, **opts)


CASES = (
    [case(f"er96_p{p}", p, "spgemm_halo", "er96") for p in (2, 4, 8)]
    + [case("powerlaw", 4, "spgemm_halo", "pl128"),
       case("rectangular", 4, "spgemm_halo", "rect_a", "rect_b"),
       case("via_dist_spgemm", 4, "dist_spgemm", "poisson12",
            schedule="halo"),
       case("banded_traffic", 8, "spgemm_halo", "banded256"),
       case("empty_shard", 4, "spgemm_halo", "empty_shards"),
       case("balanced_p8", 8, "halo", "pl300", balanced=True),
       case("wide_p4", 4, "spgemm_halo", "circuit2048"),
       case("aligned_p8", 8, "halo", "banded512", balanced=True)]
)


def jcsr(name):
    return JCSR.from_scipy(MATRICES[name]())


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Spawn 8 gloo ranks once; they run every case (rank 0 of each mesh
    writes C), bounded by a process-group timeout and a group deadline."""
    return _torch_dist_ranks.spawn_cases_once(CASES, MATRICES,
                                              tmp_path_factory, "halo")


def jax_c(c, devs):
    mesh = Mesh(np.array(devs[: c["p"]]), ("rows",))
    a = jcsr(c["a"])
    b = a if c["b"] == c["a"] else jcsr(c["b"])
    if c["kind"] == "dist_spgemm":
        return jdist.dist_spgemm(a, b, mesh, schedule="halo")
    if c["kind"] == "halo":
        plan = jhalo.build_halo_plan(
            a, b, c["p"], bounds=jdist.balanced_row_bounds(a, b, c["p"]))
        return jdist.unshard(jhalo.dist_spgemm_halo(
            plan, jdist.shard_rows(b, c["p"]), mesh))
    return jhalo.spgemm_halo(a, b, mesh)


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_halo_c_equals_reference(port_runs, eight_devices, c):
    got, _, nnz = _torch_dist_ranks.read_c(port_runs, c["name"])
    want = jax_c(c, eight_devices)
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz],
                                  np.asarray(want.colidx)[:nnz])
    np.testing.assert_allclose(got.vals.numpy()[:nnz],
                               np.asarray(want.vals)[:nnz], **TOL)
    sa = MATRICES[c["a"]]().astype(np.float32).tocsr()
    sb = MATRICES[c["b"]]().astype(np.float32).tocsr()
    assert_csr_equal(got, (sa @ sb).tocsr(), **TOL)


PLANS = ([("er96", p, False) for p in (2, 4, 8)]
         + [("pl128", 4, False), ("rect_a", 4, False), ("banded256", 8, False),
            ("empty_shards", 4, False), ("pl300", 8, True),
            ("circuit2048", 4, False), ("banded512", 8, True)])


@pytest.mark.parametrize("name,p,balanced", PLANS,
                         ids=[f"{n}-p{p}{'-balanced' if b else ''}"
                              for n, p, b in PLANS])
def test_halo_plan_equals_reference(name, p, balanced):
    """The remapped A, the send rows, the (P, P) offset and size tables,
    the halo rowptrs, the capacities and the local plan, element for
    element. The port's plan holds the remapped columns only; the rows and
    values of the reference's remapped A are its shards'."""
    ja = jcsr(name)
    jb = jcsr("rect_b") if name == "rect_a" else ja
    bounds = jdist.balanced_row_bounds(ja, jb, p) if balanced else None
    want = jhalo.build_halo_plan(ja, jb, p, bounds=bounds)
    got = thalo.build_halo_plan(bridge(ja), bridge(jb), p, bounds=bounds)
    np.testing.assert_array_equal(got.a_colidx.numpy(),
                                  np.asarray(want.a_sh.colidx))
    a_sh = tdist.shard_rows(bridge(ja), p, bounds=bounds)
    for f in ("rowptr", "vals"):
        np.testing.assert_array_equal(getattr(a_sh, f).numpy(),
                                      np.asarray(getattr(want.a_sh, f)), f)
    assert got.bounds == want.a_sh.bounds == a_sh.bounds
    for f in ("send_rows", "input_offsets", "send_sizes", "output_offsets",
              "recv_sizes", "recv_offsets", "halo_rowptr"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("send_payload_cap", "halo_nnz_cap", "shape_b"):
        assert getattr(got, f) == getattr(want, f), f
    # the reference's fields; the halo's local plan keeps the stream (the
    # row-local route, a field the reference lacks, is None)
    for f in (f.name for f in dataclasses.fields(ChunkedPlan)
              if f.name != "rowlocal"):
        assert getattr(got.local_plan, f) == getattr(want.local_plan, f), f
    assert got.local_plan.rowlocal is None


def test_halo_plan_traffic_less_than_replication():
    """Per-rank B traffic is the halo's nnz: on a band, about the local
    rows only, far below nnz(B)."""
    a = bridge(jcsr("banded256"))
    plan = thalo.build_halo_plan(a, a, 8)
    recv_per_rank = plan.recv_sizes.numpy().sum(axis=1)
    assert recv_per_rank.max() < int(a.rowptr[-1]) / 2


def test_halo_plan_rejects_another_mesh_size():
    a = bridge(jcsr("er96"))
    plan = thalo.build_halo_plan(a, a, 4)
    mesh = TMesh((0, 1), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="4-shard plan on a 2-rank mesh"):
        thalo.dist_spgemm_halo(plan, tdist.shard_rows(a, 2),
                               tdist.shard_rows(a, 2), mesh)
