"""The PyTorch port's out-of-core path (ops/batched.py,
ops/chunked.make_dist_local_plan) against the reference package on the
same seeded inputs. Plans (row blocks, per-block nnz(C), C's structure,
the chunked plan) equal exactly; float32 values within rtol 1e-4 / atol
1e-5; float64 against the x64 scipy golden at rtol / atol 1e-12."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.ops import batched as jbatched
from benchmark_spgemm_using_csr_tpu.parallel import dist as jdist
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import batched as tbatched
from benchmark_spgemm_using_csr_tpu_torch.parallel import dist as tdist

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def same_csr(got, want, **tol):
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **(tol or TOL))


def oversized_row():
    d = np.zeros((64, 64), np.float32)
    d[0, :] = d[:, 0] = 1.0
    np.fill_diagonal(d, 1.0)
    return sp.csr_matrix(d)


# (matrix, stream budget, method): each method forced with a small budget
CASES = {
    "er_chunked": (lambda: jgen.erdos_renyi(400, 400, 6.0, seed=13), 2000,
                   "chunked"),
    "powerlaw_grouped": (lambda: jgen.power_law(512, 512, alpha=2.0,
                                                max_deg=64, seed=3), 3000,
                         "grouped"),
    "dense_rows_dense": (lambda: jgen.dense_rows(256, 256, nnz_per_row=48,
                                                 seed=4), 50000, "dense"),
    "poisson_dense_gather": (lambda: jgen.poisson2d(16), 200, "dense"),
    "oversized_row_auto": (oversized_row, 100, None),
}


# dense blocks of 64 rows of 256 float32 columns
DENSE_BLOCK_BYTES = 64 * 256 * 4


@pytest.fixture
def small_dense_blocks(monkeypatch):
    """Both packages' plans cut dense blocks of DENSE_BLOCK_BYTES."""
    for mod in (jbatched, tbatched):
        monkeypatch.setattr(mod, "make_batched_plan", functools.partial(
            mod.make_batched_plan, dense_block_bytes=DENSE_BLOCK_BYTES))


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_plan_equals_reference(name, small_dense_blocks):
    make, budget, method = CASES[name]
    ja = JCSR.from_scipy(make())
    ta = bridge(ja)
    jp = jbatched.make_batched_plan(ja, ja, stream_budget=budget,
                                    method=method)
    tp = tbatched.make_batched_plan(ta, ta, stream_budget=budget,
                                    method=method)
    assert tp.method == jp.method
    for field in ("blocks", "rows_cap", "nnz_cap", "slice0", "nnz_blk",
                  "nnz_c_blk", "nnz_c", "cap_c", "cap_c_u"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert len(tp.blocks) > 1
    np.testing.assert_array_equal(tp.out_rowptr.numpy(),
                                  np.asarray(jp.out_rowptr))
    np.testing.assert_array_equal(tp.out_colidx.numpy(),
                                  np.asarray(jp.out_colidx))
    for t_rp, j_rp in zip(tp.blk_rowptr, jp.blk_rowptr):
        np.testing.assert_array_equal(t_rp.numpy(), np.asarray(j_rp))
    if tp.method == "dense":
        assert [m for m, _ in tp.flat_c] == [m for m, _ in jp.flat_c]
    if tp.method == "grouped":
        assert len(tp.grouped_scheds) == len(jp.grouped_scheds)
        for ts, js in zip(tp.grouped_scheds, jp.grouped_scheds):
            for field in ("k", "al", "cs", "g_cap", "abpad_cap", "out_cap",
                          "nnz_c", "cbits", "lbits", "max_run",
                          "scatter_set"):
                assert (getattr(ts.plan, field)
                        == getattr(js.plan, field)), field
            for field in ("slot0", "first_rank", "sorted_off", "fill_end"):
                np.testing.assert_array_equal(
                    getattr(ts, field).numpy(), np.asarray(getattr(js, field)))
    if tp.method == "chunked":
        for field in ("k", "chunks_cap", "out_cap", "max_run", "wide_min",
                      "wchunks_cap", "bpad_cap", "scatter_set", "al",
                      "abpad_cap", "al_min", "nchunks_cap"):
            assert (getattr(tp.chunked_plan, field)
                    == getattr(jp.chunked_plan, field)), field


@pytest.mark.parametrize("name", sorted(CASES))
def test_spgemm_batched_same_csr_as_reference(name, small_dense_blocks):
    make, budget, method = CASES[name]
    ja = JCSR.from_scipy(make())
    want = jbatched.spgemm_batched(ja, ja, stream_budget=budget,
                                   method=method)
    got = tbatched.spgemm_batched(bridge(ja), bridge(ja),
                                  stream_budget=budget, method=method)
    same_csr(got, want)


@pytest.mark.parametrize("density,mode", [(0.3, "full"), (0.2, "shift"),
                                          (0.01, "gather")])
def test_batched_dense_blocks_keep_payloads_on_the_host(density, mode,
                                                        monkeypatch):
    """Each dense block's extraction payload stays in the plan as a host
    tensor and goes up at its turn; each block writes its exact values
    into C, and C equals the reference's in every extraction mode."""
    s = sp.random(128, 128, density=density, random_state=5, format="csr",
                  dtype=np.float32)
    for mod in (jbatched, tbatched):
        monkeypatch.setattr(mod, "make_batched_plan", functools.partial(
            mod.make_batched_plan, dense_block_bytes=32 * 128 * 4))
    ja = JCSR.from_scipy(s)
    ta = bridge(ja)
    plan = tbatched.make_batched_plan(ta, ta, stream_budget=100,
                                      method="dense")
    assert len(plan.blocks) == 4
    assert {m for m, _ in plan.flat_c} == {mode}
    for m, payload in plan.flat_c:
        for x in ((payload,) if m == "gather" else payload or ()):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    got = tbatched.spgemm_batched(ta, ta, stream_budget=100, method="dense")
    same_csr(got, jbatched.spgemm_batched(ja, ja, stream_budget=100,
                                          method="dense"))
    assert not got.vals[plan.nnz_c:].any()


def test_batched_auto_method_is_the_references():
    s = jgen.dense_rows(256, 256, nnz_per_row=48, seed=4)
    ja = JCSR.from_scipy(s)
    jp = jbatched.make_batched_plan(ja, ja, stream_budget=50000)
    tp = tbatched.make_batched_plan(bridge(ja), bridge(ja),
                                    stream_budget=50000)
    assert tp.method == jp.method


def test_batched_in_core_when_within_budget():
    ja = JCSR.from_scipy(jgen.poisson2d(20))
    want = jbatched.spgemm_batched(ja, ja)
    got = tbatched.spgemm_batched(bridge(ja), bridge(ja))
    nnz = int(want.rowptr[-1])  # the chunked path's padding is not zeroed
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz],
                                  np.asarray(want.colidx)[:nnz])
    np.testing.assert_allclose(got.vals.numpy()[:nnz],
                               np.asarray(want.vals)[:nnz], **TOL)


@pytest.mark.parametrize("method", ["dense", "chunked"])
def test_batched_as_scipy(method):
    s = jgen.erdos_renyi(300, 300, 5.0, seed=2)
    a = T.CSR.from_scipy(s, device="cpu")
    got = tbatched.spgemm_batched(a, a, stream_budget=1500, as_scipy=True,
                                  method=method)
    assert isinstance(got, sp.csr_matrix)
    want = (s @ s).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, **TOL)


@pytest.mark.parametrize("method", ["dense", "grouped", "chunked"])
def test_batched_float64_against_scipy(method):
    s = jgen.erdos_renyi(300, 300, 5.0, seed=9, dtype=np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    got = tbatched.spgemm_batched(a, a, stream_budget=1500, method=method)
    assert got.vals.dtype == torch.float64
    want = (s @ s).tocsr()
    want.sort_indices()
    nnz = want.nnz
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(got.vals.numpy()[:nnz], want.data, **F64)


def test_plan_row_batches_equals_reference():
    nnz_ct = np.random.default_rng(0).integers(0, 50, size=1000)
    nnz_ct[[3, 500]] = 400  # rows over the budget stand alone
    for budget in (25, 100, 1000, 10 ** 6):
        assert (tbatched.plan_row_batches(nnz_ct, budget)
                == jbatched.plan_row_batches(nnz_ct, budget))
    assert tbatched.plan_row_batches(np.zeros(0, np.int64), 10) == [(0, 0)]


def test_dist_local_plan_equals_reference():
    ja = JCSR.from_scipy(jgen.power_law(600, 600, alpha=2.0, max_deg=300,
                                        seed=1))
    ta = bridge(ja)
    for n_shards, bounds in ((4, np.array([0, 150, 300, 450, 600])),
                             (3, np.array([0, 100, 450, 600]))):
        jp = jdist.make_dist_local_plan(ja, ja, n_shards, bounds=bounds)
        tp = tdist.make_dist_local_plan(ta, ta, n_shards, bounds=bounds)
        for field in ("k", "chunks_cap", "out_cap", "wchunks_cap",
                      "bpad_cap", "al", "abpad_cap", "scatter_set"):
            assert getattr(tp, field) == getattr(jp, field), field
