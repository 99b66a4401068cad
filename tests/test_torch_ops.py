"""The PyTorch port's SpMV/SpMM, SpAdd and SpTRSV (ops/spmv.py,
ops/spadd.py, ops/sptrsv.py, native/levels) and the BhSparse facade
(compat.py) against the reference package on the same seeded inputs.
Plans, levels and structures equal exactly; float32 values within rtol
1e-4 / atol 1e-5; float64 against the x64 scipy golden at rtol / atol
1e-12."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.compat import BhSparse as JBhSparse
from benchmark_spgemm_using_csr_tpu.native import levels as jlevels
from benchmark_spgemm_using_csr_tpu.ops import spadd as jspadd
from benchmark_spgemm_using_csr_tpu.ops import spmv as jspmv
from benchmark_spgemm_using_csr_tpu.ops import sptrsv as jsptrsv
from benchmark_spgemm_using_csr_tpu.sparse.csr import BSR as JBSR
from benchmark_spgemm_using_csr_tpu.sparse.csr import (
    csr_transpose as j_transpose,
)
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.native import levels as tlevels
from benchmark_spgemm_using_csr_tpu_torch.ops import spadd as tspadd
from benchmark_spgemm_using_csr_tpu_torch.ops import spmv as tspmv
from benchmark_spgemm_using_csr_tpu_torch.ops import sptrsv as tsptrsv

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def same_entries(got, want, **tol):
    """rowptr and the first nnz entries equal (the reference's shift
    compaction leaves stale entries in its padding; the port's is 0)."""
    nnz = int(want.rowptr[-1])
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz],
                                  np.asarray(want.colidx)[:nnz])
    np.testing.assert_allclose(got.vals.numpy()[:nnz],
                               np.asarray(want.vals)[:nnz], **(tol or TOL))
    assert not got.colidx[nnz:].any() and not got.vals[nnz:].any()


MATS = {
    "powerlaw": lambda: jgen.power_law(300, 300, alpha=2.0, max_deg=60,
                                       seed=3),
    "poisson2d": lambda: jgen.poisson2d(20),
    "rect": lambda: sp.random(120, 90, density=0.05, random_state=5,
                              format="csr", dtype=np.float32),
}


# ---- SpMV / SpMM ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MATS))
def test_spmv_spmm_spmv_t_equal_reference(name):
    s = MATS[name]()
    ja = JCSR.from_scipy(s)
    ta = bridge(ja)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(s.shape[1]).astype(np.float32)
    xk = rng.standard_normal((s.shape[1], 7)).astype(np.float32)
    y = rng.standard_normal(s.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tspmv.spmv(ta, torch.from_numpy(x)).numpy(),
                               np.asarray(jspmv.spmv(ja, x)), **TOL)
    np.testing.assert_allclose(tspmv.spmm(ta, torch.from_numpy(xk)).numpy(),
                               np.asarray(jspmv.spmm(ja, xk)), **TOL)
    np.testing.assert_allclose(
        tspmv.spmv_t(ta, torch.from_numpy(y), s.shape[1]).numpy(),
        np.asarray(jspmv.spmv_t(ja, y, s.shape[1])), **TOL)


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 16)])
def test_bsr_spmm_equals_reference(block_shape):
    s = jgen.banded(256, 6, seed=4)
    jb = JBSR.from_scipy(s, block_shape=block_shape)
    tb = T.BSR.from_scipy(s, block_shape=block_shape, device="cpu")
    x = np.random.default_rng(1).standard_normal((256, 5)).astype(np.float32)
    got = tspmv.bsr_spmm(tb, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jspmv.bsr_spmm(jb, x)), **TOL)
    np.testing.assert_allclose(got, s @ x, rtol=1e-4, atol=1e-4)


def test_spmv_float64_against_scipy():
    s = MATS["powerlaw"]().astype(np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    x = np.random.default_rng(2).standard_normal(300)
    np.testing.assert_allclose(tspmv.spmv(a, torch.from_numpy(x)).numpy(),
                               s @ x, **F64)


# ---- SpAdd -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MATS))
def test_spadd_plan_and_sum_equal_reference(name):
    s = MATS[name]()
    other = sp.random(*s.shape, density=0.04, random_state=8, format="csr",
                      dtype=np.float32)
    ja, jb = JCSR.from_scipy(s), JCSR.from_scipy(other)
    ta, tb = bridge(ja), bridge(jb)
    jp = jspadd.make_add_plan(ja, jb)
    tp = tspadd.make_add_plan(ta, tb)
    assert tp == tspadd.AddPlan(jp.out_cap, jp.pack_u32, jp.disp_bits)
    same_entries(tspadd.spadd_planned(ta, tb, tp, 0.5, -2.0),
                 jspadd.spadd_planned(ja, jb, jp, 0.5, -2.0))


def test_spadd_symmetrization_equals_reference():
    s = MATS["powerlaw"]()
    ja = JCSR.from_scipy(s)
    jt = j_transpose(ja)
    ta = bridge(ja)
    tt = T.csr_transpose(ta)
    same_entries(tspadd.spadd(ta, tt), jspadd.spadd(ja, jt))


def test_spadd_float64_against_scipy():
    s = MATS["poisson2d"]().astype(np.float64)
    o = sp.random(*s.shape, density=0.05, random_state=3, format="csr")
    got = tspadd.spadd(T.CSR.from_scipy(s, device="cpu"),
                       T.CSR.from_scipy(o, device="cpu"), 1.5, 0.25)
    want = (1.5 * s + 0.25 * o).tocsr()
    want.sort_indices()
    nnz = want.nnz
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(got.vals.numpy()[:nnz], want.data, **F64)


# ---- SpTRSV -------------------------------------------------------------------


def triangular_host(m=200, seed=0, dtype=np.float32):
    """A well-conditioned square matrix: random off-diagonals plus a
    dominant diagonal (its lower and upper triangles are both solvable)."""
    s = sp.random(m, m, density=0.04, random_state=seed, format="csr",
                  dtype=dtype)
    shift = np.abs(s).sum(axis=1).max() + 1.0
    return (s + sp.identity(m, dtype, format="csr") * shift).tocsr()


@pytest.mark.parametrize("upper", [False, True])
def test_levels_native_and_numpy_equal_reference(upper):
    s = triangular_host(300, seed=4)
    rp, ci = s.indptr.astype(np.int32), s.indices.astype(np.int32)
    want = jlevels.csr_levels(rp, ci, 300, upper=upper)
    np.testing.assert_array_equal(tlevels.csr_levels(rp, ci, 300, upper),
                                  want)
    np.testing.assert_array_equal(tlevels._levels_numpy(rp, ci, 300, upper),
                                  want)


@pytest.mark.parametrize("lower,unit_diag", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_sptrsv_plan_and_solution_equal_reference(lower, unit_diag):
    ja = JCSR.from_scipy(triangular_host(200, seed=1))
    ta = bridge(ja)
    js = jsptrsv.make_trsv_plan(ja, lower=lower, unit_diag=unit_diag)
    ts = tsptrsv.make_trsv_plan(ta, lower=lower, unit_diag=unit_diag)
    assert ts.plan == tsptrsv.TrsvPlan(**vars(js.plan))
    np.testing.assert_array_equal(ts.stream.numpy(), np.asarray(js.stream))
    np.testing.assert_array_equal(ts.diag_pos.numpy(), np.asarray(js.diag_pos))
    b = np.random.default_rng(2).standard_normal(200).astype(np.float32)
    want = np.asarray(jsptrsv.sptrsv_planned(ja, b, js))
    got = tsptrsv.sptrsv_planned(ta, torch.from_numpy(b), ts).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sptrsv_multi_rhs_equals_reference():
    ja = JCSR.from_scipy(triangular_host(150, seed=5))
    b = np.random.default_rng(3).standard_normal((150, 4)).astype(np.float32)
    want = np.asarray(jsptrsv.sptrsv(ja, b, lower=False))
    got = tsptrsv.sptrsv(bridge(ja), torch.from_numpy(b), lower=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("lower", [True, False])
def test_sptrsv_float64_against_scipy(lower):
    s = triangular_host(250, seed=6, dtype=np.float64)
    b = np.random.default_rng(4).standard_normal(250)
    got = tsptrsv.sptrsv(T.CSR.from_scipy(s, device="cpu"),
                         torch.from_numpy(b), lower=lower)
    tri = sp.tril(s, format="csr") if lower else sp.triu(s, format="csr")
    want = spsolve_triangular(tri, b, lower=lower)
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_sptrsv_rejects_singular():
    s = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 0.0]], np.float32))
    with pytest.raises(ValueError, match="no stored diagonal"):
        tsptrsv.make_trsv_plan(T.CSR.from_scipy(s, device="cpu"))


def test_ilu0_apply_exact_equals_reference():
    ja = JCSR.from_scipy(triangular_host(180, seed=7))
    r = np.random.default_rng(5).standard_normal(180).astype(np.float32)
    want = np.asarray(jsptrsv.ilu0_apply_exact(ja, r))
    got = tsptrsv.ilu0_apply_exact(bridge(ja), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---- BhSparse ------------------------------------------------------------------


def test_bhsparse_lifecycle_equals_reference():
    sa = jgen.erdos_renyi(300, 200, 5.0, seed=11)
    sb = jgen.erdos_renyi(200, 250, 5.0, seed=12)
    args = (300, 200, 250, sa.indptr, sa.indices, sa.data,
            sb.indptr, sb.indices, sb.data)
    j = JBhSparse(method="esc")
    j.init_platform()
    j.init_data(*args)
    j.spgemm()
    t = T.BhSparse(method="esc")
    assert t.init_platform("cpu") == "cpu"
    t.init_data(*args)
    t.spgemm()
    assert t.get_nnz_c() == j.get_nnz_c()
    for got, want in zip(t.get_c()[:2], j.get_c()[:2]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t.get_c()[2], j.get_c()[2], **TOL)
    t.free_mem()
    with pytest.raises(RuntimeError, match="spgemm"):
        t.get_c()
    with pytest.raises(RuntimeError, match="init_data"):
        t.spgemm()


def test_bhsparse_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.BhSparse().init_platform()
