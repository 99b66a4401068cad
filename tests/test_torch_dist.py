"""The port's row-sharded schedules (parallel/dist.py, parallel/mesh.py)
against the reference package on the same seeded inputs, the reference's
own test matrices and sizes.

- Host plans (``shard_rows``, ``balanced_row_bounds``,
  ``make_dist_local_plan``, ``DistGroupedPlan``, ``RingStatics`` and
  ``RingPlan``) equal the reference's element for element, in process.
- C: one group of 8 gloo ranks is spawned for the module (with meshes of
  2 and 4 ranks carved out of it) and runs every case once
  (``_torch_dist_ranks``); each case then holds its C against the JAX
  package's C on the ``eight_devices`` virtual mesh (structure exactly,
  float32 values within rtol 1e-4 / atol 1e-5) and against scipy.
  float64 is held against x64 scipy at rtol / atol 1e-12, bfloat16
  against scipy's float32 product of the rounded values at rtol 2e-2 /
  atol 1e-2.
- The memoized plans and shards serve a second call whose A has new
  values (a new tensor beside the same index tensors, or the same tensor
  written in place) with those values, against scipy.
"""
import dataclasses
import gc
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.ops import spadd as jspadd
from benchmark_spgemm_using_csr_tpu.parallel import dist as jdist
from benchmark_spgemm_using_csr_tpu.parallel import halo as jhalo
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen
from benchmark_spgemm_using_csr_tpu.utils.oracle import random_csr

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch import compat
from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch as tdispatch
from benchmark_spgemm_using_csr_tpu_torch.ops.chunked import ChunkedPlan
from benchmark_spgemm_using_csr_tpu_torch.parallel import dist as tdist
from benchmark_spgemm_using_csr_tpu_torch.sparse import csr as tcsr
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    TOLERANCES,
    assert_csr_equal,
)

import _torch_dist_ranks

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)

# the reference's test matrices (tests/test_dist.py), by name
MATRICES = {
    "er257": lambda: jgen.erdos_renyi(257, 257, 5.0, seed=3),
    "rect_a": lambda: random_csr(120, 90, density=0.07, seed=4).to_scipy(),
    "rect_b": lambda: random_csr(90, 150, density=0.07, seed=5).to_scipy(),
    "pl300": lambda: jgen.power_law(300, 300, alpha=1.8, max_deg=128, seed=6),
    "rnd64": lambda: random_csr(64, 64, density=0.1, seed=7).to_scipy(),
    "pl415": lambda: jgen.power_law(415, 415, alpha=1.8, max_deg=150, seed=9),
    "pl300_11": lambda: jgen.power_law(300, 300, alpha=1.8, max_deg=64,
                                       seed=11),
    "add_a": lambda: _spadd_pair()[0],
    "add_b": lambda: _spadd_pair()[1],
    "er257_1": lambda: jgen.erdos_renyi(257, 257, 6.0, seed=1),
    "er257_2": lambda: jgen.erdos_renyi(257, 257, 6.0, seed=2),
    # chunk width 8 (al-aligned plan): the ring's k > 1 lanes
    "circuit1024": lambda: jgen.circuit(1024, seed=3),
    "rows101": lambda: random_csr(101, 64, density=0.08, seed=0).to_scipy(),
    "circuit2048": lambda: jgen.circuit(2048, seed=3),  # wide split
    "banded512": lambda: jgen.banded(512, bandwidth=12, seed=2),  # al 16
}


def _spadd_pair():
    rng = np.random.default_rng(3)
    return [sp.random(300, 200, density=0.05, random_state=rng,
                      format="csr", dtype=np.float32) for _ in range(2)]


def jcsr(name):
    return JCSR.from_scipy(MATRICES[name]())


def bridge(j, dtype=None):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu",
                            dtype=dtype)


def case(name, p, kind, a, b=None, **opts):
    return dict(name=name, p=p, kind=kind, a=a, b=b or a, **opts)


# every case the ranks run; float32 unless named
CASES = (
    [case(f"square_{s}_p{p}", p, "dist_spgemm", "er257", schedule=s)
     for s in ("replicated", "ring", "halo") for p in (2, 4, 8)]
    + [case(f"rect_{s}", 8, "dist_spgemm", "rect_a", "rect_b", schedule=s)
       for s in ("replicated", "ring", "halo")]
    + [case("powerlaw_ring", 8, "dist_spgemm", "pl300", schedule="ring"),
       case("balanced_replicated", 8, "replicated", "pl300", balanced=True)]
    + [case(f"balanced_ring_hop{h}", 8, "ring", "pl300", balanced=True,
            hop=h) for h in (1, 2, 4, 8)]
    + [case("balanced_halo", 8, "halo", "pl300", balanced=True),
       case("two_ranks_ring", 2, "dist_spgemm", "rnd64", schedule="ring"),
       case("grouped_forced", 8, "replicated", "pl415", grouped=True),
       case("grouped_balanced", 4, "replicated", "pl415", grouped=True,
            balanced=True),
       case("grouped_auto", 4, "dist_spgemm", "pl300_11",
            schedule="replicated"),
       case("ring_k8_p4", 4, "dist_spgemm", "circuit1024", schedule="ring"),
       case("ring_k8_p8", 8, "dist_spgemm", "circuit1024", schedule="ring"),
       case("spadd", 8, "spadd", "add_a", "add_b", alpha=2.0, beta=-1.0),
       case("spadd_single", 4, "spadd", "er257_1", "er257_2")]
)
OTHER_TYPES = (
    [case(f"float64_{s}", 4, "dist_spgemm", "er257", schedule=s,
          dtype="float64") for s in ("replicated", "ring", "halo")]
    + [case(f"bfloat16_{s}", 4, "dist_spgemm", "circuit1024", schedule=s,
            dtype="bfloat16") for s in ("ring", "halo")]
)


REVALUED = [case(f"revalue_{how}_{s}", 4, "revalue", "er257", schedule=s,
                 how=how, scale=-1.5)
            for how in ("new", "inplace")
            for s in ("replicated", "ring", "halo")]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Spawn 8 gloo ranks once; they run every case (rank 0 of each mesh
    writes C). Bounded by a process-group timeout and a group deadline
    (``_torch_dist_ranks.spawn_cases_once``)."""
    return _torch_dist_ranks.spawn_cases_once(
        CASES + OTHER_TYPES + REVALUED, MATRICES, tmp_path_factory, "dist")


def port_c(out, name):
    return _torch_dist_ranks.read_c(out, name)


def jax_c(c, eight_devices):
    """The JAX package's C of a case, on the eight_devices mesh."""
    p, kind = c["p"], c["kind"]
    mesh = jdist.make_mesh(p)
    a = jcsr(c["a"])
    b = a if c["b"] == c["a"] else jcsr(c["b"])
    bounds = jdist.balanced_row_bounds(a, b, p) if c.get("balanced") else None
    if kind == "dist_spgemm":
        return jdist.dist_spgemm(a, b, mesh, schedule=c["schedule"])
    if kind == "replicated":
        a_sh = jdist.shard_rows(a, p, bounds=bounds)
        if c.get("grouped"):
            gp = jdist.make_dist_grouped_plan(a, b, p, bounds=bounds)
            return jdist.unshard(jdist.dist_spgemm_replicated(
                a_sh, b, mesh, grouped_plan=gp))
        lp = jdist.make_dist_local_plan(a, b, p, bounds=bounds)
        return jdist.unshard(jdist.dist_spgemm_replicated(a_sh, b, mesh,
                                                          plan=lp))
    if kind == "ring":
        rplan = jdist.make_ring_plan(a, b, p, bounds=bounds, hop=c["hop"])
        return jdist.unshard(jdist.dist_spgemm_ring(
            jdist.shard_rows(a, p, bounds=bounds), jdist.shard_rows(b, p),
            a.rowptr, mesh, ring_plan=rplan))
    if kind == "halo":
        hplan = jhalo.build_halo_plan(a, b, p, bounds=bounds)
        return jdist.unshard(jhalo.dist_spgemm_halo(
            hplan, jdist.shard_rows(b, p), mesh))
    return jdist.dist_spadd(a, b, mesh, alpha=c.get("alpha", 1.0),
                            beta=c.get("beta", 1.0))


def golden(c):
    sa = MATRICES[c["a"]]().astype(np.float32).tocsr()
    sb = MATRICES[c["b"]]().astype(np.float32).tocsr()
    if c["kind"] == "spadd":
        return (c.get("alpha", 1.0) * sa + c.get("beta", 1.0) * sb).tocsr()
    return (sa @ sb).tocsr()


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_schedule_c_equals_reference(port_runs, eight_devices, c):
    got, _, nnz = port_c(port_runs, c["name"])
    want = jax_c(c, eight_devices)
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz],
                                  np.asarray(want.colidx)[:nnz])
    np.testing.assert_allclose(got.vals.numpy()[:nnz],
                               np.asarray(want.vals)[:nnz], **TOL)
    assert_csr_equal(got, golden(c), check_explicit_zeros=c["kind"] != "spadd",
                     **TOL)


def test_dist_spadd_matches_single_chip(port_runs):
    """dist_spadd on a non-divisible m equals the single-chip spadd of
    both packages."""
    got, _, nnz = port_c(port_runs, "spadd_single")
    a, b = jcsr("er257_1"), jcsr("er257_2")
    one = T.spadd(bridge(a), bridge(b))
    np.testing.assert_array_equal(got.rowptr.numpy(), one.rowptr.numpy())
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz],
                                  one.colidx.numpy()[:nnz])
    np.testing.assert_allclose(got.vals.numpy()[:nnz], one.vals.numpy()[:nnz],
                               **TOL)
    ref = jspadd.spadd(a, b)
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(ref.rowptr))


def test_grouped_auto_pick_equals_reference(port_runs, eight_devices):
    """dist_spgemm's replicated schedule takes the grouped local kernel
    exactly where the reference's does (the dispatcher's cost model)."""
    from benchmark_spgemm_using_csr_tpu.ops import dispatch as jdispatch

    a = jcsr("pl300_11")
    want = ("DistGroupedPlan"
            if jdispatch.estimate_grouped_s(a) < jdispatch.estimate_chunked_s(a)
            else "ChunkedPlan")
    _, note, _ = port_c(port_runs, "grouped_auto")
    assert note == want


@pytest.mark.parametrize("c", OTHER_TYPES, ids=[c["name"] for c in OTHER_TYPES])
def test_schedule_c_in_other_types(port_runs, c):
    got, _, _ = port_c(port_runs, c["name"])
    s = MATRICES[c["a"]]().tocsr()
    if c["dtype"] == "float64":
        s = s.astype(np.float64)
        assert_csr_equal(got, (s @ s).tocsr(), **F64)
    else:  # the float32 product of the bfloat16-rounded values
        r = bridge(JCSR.from_scipy(s.astype(np.float32)), torch.bfloat16)
        s = r.to_scipy()
        assert_csr_equal(got, (s @ s).tocsr(), check_explicit_zeros=False,
                         **TOLERANCES["bfloat16"])


@pytest.mark.parametrize("c", REVALUED, ids=[c["name"] for c in REVALUED])
def test_schedule_c_after_new_values(port_runs, c):
    """The second call's C is the product of the new values: no memo
    (the schedule's plan, the sharded A) serves the old ones."""
    got, _, _ = port_c(port_runs, c["name"])
    s = MATRICES[c["a"]]().astype(np.float32).tocsr() * np.float32(
        c["scale"])
    assert_csr_equal(got, (s @ s).tocsr(), **TOL)


def test_mesh_refuses_a_tensor_off_its_backend(port_runs):
    """gloo carries CPU tensors only: every collective raises on another
    device's tensor rather than moving it."""
    with open(os.path.join(port_runs, "_mesh.json")) as f:
        info = json.load(f)
    assert info == {"backend": "gloo", "mismatch_raises": True}


# ---------------------------------------------------------------------------
# host plans, element for element (no ranks needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", ["uniform", "balanced"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_shard_rows_equals_reference(partition, p):
    j = jcsr("rows101" if partition == "uniform" else "pl300")
    t = bridge(j)
    bounds = (jdist.balanced_row_bounds(j, j, p) if partition == "balanced"
              else None)
    want = jdist.shard_rows(j, p, bounds=bounds)
    got = tdist.shard_rows(t, p, bounds=bounds)
    for f in ("rowptr", "colidx", "vals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert (got.shape, got.bounds, got.m_loc, got.cap) == (
        want.shape, want.bounds, want.m_loc, want.cap)
    back, jback = tdist.unshard(got), jdist.unshard(want)
    for f in ("rowptr", "colidx", "vals"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)), f)
    assert_csr_equal(back, j.to_scipy(), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["pl300", "er257", "rect_a"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_balanced_row_bounds_equals_reference(name, p):
    j = jcsr(name)
    b = jcsr("rect_b") if name == "rect_a" else j
    np.testing.assert_array_equal(
        tdist.balanced_row_bounds(bridge(j), bridge(b), p),
        jdist.balanced_row_bounds(j, b, p))


# the reference's fields; the port's shard plans keep the stream (their
# row-local route, a field the reference lacks, is None)
PLAN_FIELDS = [f.name for f in dataclasses.fields(ChunkedPlan)
               if f.name != "rowlocal"]


def halo_lens_of(j, p, bounds):
    """Per shard, the B row lengths of its halo (sorted unique columns)."""
    rp = np.asarray(j.rowptr)
    ci = np.asarray(j.colidx)[: int(rp[-1])]
    b_len = np.diff(rp)
    if bounds is None:
        m_loc = -(-j.m // p)
        bounds = np.minimum(np.arange(p + 1) * m_loc, j.m)
    return [b_len[np.unique(ci[rp[lo]:rp[hi]])]
            for lo, hi in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("with_halo", [False, True], ids=["plain", "halo"])
@pytest.mark.parametrize("partition", ["uniform", "balanced"])
@pytest.mark.parametrize("name", ["er257", "circuit2048", "banded512"])
def test_dist_local_plan_equals_reference(name, partition, with_halo):
    """make_dist_local_plan field by field, for both partitions and with
    halo-sized tables: narrow (er257), wide split (circuit2048) and
    al-aligned (banded512) plans, over 4 shards."""
    j = jcsr(name)
    p = 4
    bounds = (jdist.balanced_row_bounds(j, j, p) if partition == "balanced"
              else None)
    hl = halo_lens_of(j, p, bounds) if with_halo else None
    want = jdist.make_dist_local_plan(j, j, p, halo_lens=hl, bounds=bounds)
    got = tdist.make_dist_local_plan(bridge(j), bridge(j), p, halo_lens=hl,
                                     bounds=bounds)
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.rowlocal is None


@pytest.mark.parametrize("partition", ["uniform", "balanced"])
def test_dist_grouped_plan_equals_reference(partition):
    j = jcsr("pl415")
    bounds = (jdist.balanced_row_bounds(j, j, 8) if partition == "balanced"
              else None)
    want = jdist.make_dist_grouped_plan(j, j, 8, bounds=bounds)
    got = tdist.make_dist_grouped_plan(bridge(j), bridge(j), 8, bounds=bounds)
    for f in ("k", "al", "cs", "g_cap", "abpad_cap", "out_cap", "nnz_c",
              "cbits", "lbits", "max_run", "scatter_set"):
        assert getattr(got.plan, f) == getattr(want.plan, f), f
    for f in ("slot0", "first_rank", "sorted_off", "fill_end"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


RING_PLANS = ([("pl300", 8, True, h) for h in (1, 2, 4, 8)]
              + [("er257", 2, False, 1), ("er257", 4, False, 2),
                 ("circuit1024", 4, False, 1), ("rect_a", 8, False, 2)])


@pytest.mark.parametrize("name,p,balanced,hop", RING_PLANS,
                         ids=[f"{n}-p{p}-{'bal' if b else 'uni'}-hop{h}"
                              for n, p, b, h in RING_PLANS])
def test_ring_plan_equals_reference(name, p, balanced, hop):
    j = jcsr(name)
    jb = jcsr("rect_b") if name == "rect_a" else j
    bounds = jdist.balanced_row_bounds(j, jb, p) if balanced else None
    want = jdist.make_ring_plan(j, jb, p, bounds=bounds, hop=hop)
    got = tdist.make_ring_plan(bridge(j), bridge(jb), p, bounds=bounds,
                               hop=hop)
    assert got.statics.__dict__ == want.statics.__dict__
    assert got.bounds == want.bounds
    for f in ("a_col", "a_row", "chunkptr", "rp_glob_pad"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # the plan holds no values: the shards' values in its entry order
    a_sh = tdist.shard_rows(bridge(j), p, bounds=bounds)
    a_val = torch.stack([got.a_val(a_sh, d) for d in range(p)])
    np.testing.assert_array_equal(a_val.numpy(), np.asarray(want.a_val))


def test_ring_hop_must_divide_the_ranks():
    t = bridge(jcsr("er257"))
    with pytest.raises(ValueError, match="must divide"):
        tdist.make_ring_plan(t, t, 8, hop=3)
    assert [tdist.default_ring_hop(p) for p in (1, 2, 4, 8, 12, 16)] == [
        1, 1, 1, 2, 3, 4]


def test_sharded_csr_from_arrays_carries_the_reference_shards():
    """compat.sharded_csr_from_arrays takes the JAX package's stacked
    buffers; each rank's local_shard is that shard's block."""
    j = jcsr("pl300")
    bounds = jdist.balanced_row_bounds(j, j, 4)
    jsh = jdist.shard_rows(j, 4, bounds=bounds)
    sh = compat.sharded_csr_from_arrays(
        np.asarray(jsh.rowptr), np.asarray(jsh.colidx), np.asarray(jsh.vals),
        jsh.shape, jsh.bounds, device="cpu")
    ref = tdist.shard_rows(bridge(j), 4, bounds=bounds)
    for f in ("rowptr", "colidx", "vals"):
        assert torch.equal(getattr(sh, f), getattr(ref, f)), f
    assert (sh.shape, sh.bounds) == (ref.shape, ref.bounds)
    for r in range(4):
        blk = tdist.local_shard(sh, r)
        assert blk.shape == (jsh.m_loc, j.n)
        np.testing.assert_array_equal(blk.rowptr.numpy(),
                                      np.asarray(jsh.rowptr)[r])
    with pytest.raises(ValueError, match="disagree"):
        compat.sharded_csr_from_arrays(np.zeros((2, 3)), np.zeros((2, 4)),
                                       np.zeros((2, 5)), (4, 4), device="cpu")


# ---------------------------------------------------------------------------
# the memos hold their matrices weakly
# ---------------------------------------------------------------------------


def meta_csr(n=16):
    """A CSR on the meta device (standing in for a device CSR) whose host
    mirror holds a real structure."""
    rowptr = torch.empty(n + 1, dtype=torch.int32, device="meta")
    colidx = torch.empty(n, dtype=torch.int32, device="meta")
    tcsr._remember_host(rowptr, np.arange(n + 1, dtype=np.int32))
    tcsr._remember_host(colidx, np.arange(n, dtype=np.int32))
    return T.CSR(rowptr, colidx, torch.empty(n, device="meta"), (n, n))


def test_mstats_holds_matrices_weakly():
    """ops/pair_stats keeps a pair's statistics while its matrices live
    and drops them when one is collected: a recycled id() finds nothing."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import pair_stats

    pair_stats._PSTATS.clear()
    a = meta_csr()
    stats = pair_stats.pair_stats(a, a)
    assert stats.nnz_a == 16 and stats.rows_ne == 16
    assert len(pair_stats._PSTATS) == 1
    assert pair_stats.pair_stats(a, a) is stats  # a hit
    del a
    gc.collect()
    assert len(pair_stats._PSTATS) == 0


def test_dist_caches_hold_matrices_weakly():
    """shard_rows_cached and the plan memo hit on the same matrix and let
    go of it when it is collected."""
    tdist._SHARD_CACHE.clear()
    tdist._PLAN_CACHE.clear()
    a = bridge(jcsr("er257"))
    sh = tdist.shard_rows_cached(a, 4)
    assert tdist.shard_rows_cached(a, 4) is sh
    plan = tdist.dist_plan(a, a, 4, "ring")
    assert tdist.dist_plan(a, a, 4, "ring") is plan
    assert plan.statics.hop == 1
    assert len(tdist._SHARD_CACHE) == 1 and len(tdist._PLAN_CACHE) == 1
    with pytest.raises(ValueError, match="unknown schedule"):
        tdist.dist_plan(a, a, 4, "tree")
    del a
    gc.collect()
    assert len(tdist._SHARD_CACHE) == 0 and len(tdist._PLAN_CACHE) == 0


def test_identity_memo_misses_after_an_in_place_write():
    """A value stored for a tensor is not served once the tensor was
    written in place (host_view's mirror and the dist memos rely on it)."""
    memo = tcsr.IdentityMemo(4)
    x = torch.zeros(3)
    memo.put((x,), (), "old")
    assert memo.get((x,)) == "old"
    x.mul_(2.0)
    assert memo.get((x,)) is None
    memo.put((x,), (), "new")
    assert memo.get((x,)) == "new"
    with torch.inference_mode():  # keeps no version counter
        y = torch.zeros(3)
    memo.put((y,), (), "y")
    assert memo.get((y,)) == "y"


def test_identity_memo_evicts_the_least_recently_used():
    memo = tcsr.IdentityMemo(2)
    x, y, z = (torch.empty(1) for _ in range(3))
    memo.put((x,), (), "x")
    memo.put((y,), (), "y")
    assert memo.get((x,)) == "x"  # x is now the most recent
    memo.put((z,), (), "z")
    assert memo.get((y,)) is None and memo.get((x,)) == "x"
    assert memo.get((x,), ("other",)) is None
