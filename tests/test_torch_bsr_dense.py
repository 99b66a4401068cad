"""The PyTorch port's BSR container and its bsr and dense SpGEMM paths
(sparse/csr.BSR, ops/bsr.py, ops/dense.py) against the reference package
on the same seeded inputs. Plans and structures equal exactly; float32
values within rtol 1e-4 / atol 1e-5 (block products summed in another
order); float64 against the x64 scipy golden at rtol / atol 1e-12."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.ops import bsr as jbsr
from benchmark_spgemm_using_csr_tpu.ops import dense as jdense
from benchmark_spgemm_using_csr_tpu.sparse.csr import BSR as JBSR
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import bsr as tbsr
from benchmark_spgemm_using_csr_tpu_torch.ops import dense as tdense

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


def scipy_square(s):
    """A @ A in float64 by scipy, canonical."""
    c = (s @ s).tocsr()
    c.sort_indices()
    return c


def assert_csr_vs_scipy(got, want, **tol):
    nnz = want.nnz
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(got.vals.numpy()[:nnz], want.data, **tol)


# ---- the BSR container ----------------------------------------------------

BLOCKED = {
    "banded_1024": lambda: (jgen.banded(1024, 8, seed=1),) * 2,
    "dense_rows_256": lambda: (jgen.dense_rows(256, 256, nnz_per_row=24,
                                               seed=2),) * 2,
    "rect_256_384_256": lambda: (
        sp.random(256, 384, density=0.03, random_state=3, format="csr",
                  dtype=np.float32),
        sp.random(384, 256, density=0.03, random_state=4, format="csr",
                  dtype=np.float32)),
}


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64)])
def test_bsr_container_is_the_reference_layout(block_shape):
    s = jgen.banded(512, 5, seed=7)
    jb = JBSR.from_scipy(s, block_shape=block_shape)
    tb = T.BSR.from_scipy(s, block_shape=block_shape, device="cpu")
    np.testing.assert_array_equal(tb.rowptr.numpy(), np.asarray(jb.rowptr))
    np.testing.assert_array_equal(tb.colidx.numpy(), np.asarray(jb.colidx))
    np.testing.assert_array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    assert (tb.block_shape, tb.mb, tb.nb, int(tb.nnzb)) == (
        jb.block_shape, jb.mb, jb.nb, int(jb.nnzb))
    same_csr(tb.to_csr(), jb.to_csr(), rtol=0, atol=0)
    # the bridge carries the reference's state across
    tb2 = T.BSR.from_numpy(np.asarray(jb.rowptr), np.asarray(jb.colidx),
                           np.asarray(jb.blocks), jb.shape, device="cpu")
    assert (tb2.to_scipy() != jb.to_scipy()).nnz == 0


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_bsr_spgemm_same_blocks_as_reference(name):
    sa, sb = BLOCKED[name]()
    ja = JBSR.from_scipy(sa, block_shape=(8, 128))
    jb = JBSR.from_scipy(sb, block_shape=(128, 128))
    ta = T.BSR.from_scipy(sa, block_shape=(8, 128), device="cpu")
    tb = T.BSR.from_scipy(sb, block_shape=(128, 128), device="cpu")
    jplan = jbsr.make_bsr_plan(ja, jb)
    tplan = tbsr.make_bsr_plan(ta, tb)
    assert tplan == tbsr.BsrPlan(jplan.pairs_cap, jplan.out_blocks_cap)
    want = jbsr.bsr_spgemm(ja, jb, jplan)
    got = tbsr.bsr_spgemm(ta, tb, tplan)
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want.blocks),
                               **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_streamed_chunks_equal_one_chunk(dtype, monkeypatch):
    """A chunk budget that cuts the pairs into at least 3 chunks gives the
    blocks of one chunk (the products add into their slots in the same
    order on the CPU)."""
    s = jgen.dense_rows(256, 256, nnz_per_row=24, seed=2).astype(dtype)
    ta = T.BSR.from_scipy(s, block_shape=(8, 128), device="cpu")
    tb = T.BSR.from_scipy(s, block_shape=(128, 128), device="cpu")
    plan = tbsr.make_bsr_plan(ta, tb)
    whole = tbsr.bsr_spgemm(ta, tb, plan)
    calls = []
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda x, y: calls.append(1) or bmm(x, y))
    per_pair = 128 * 128 * np.dtype(dtype).itemsize
    monkeypatch.setattr(tbsr, "BSR_CHUNK_BYTES",
                        per_pair * (plan.pairs_cap // 3 - 1))
    got = tbsr.bsr_spgemm(ta, tb, plan)
    assert len(calls) >= 3
    np.testing.assert_array_equal(got.rowptr.numpy(), whole.rowptr.numpy())
    np.testing.assert_array_equal(got.colidx.numpy(), whole.colidx.numpy())
    np.testing.assert_allclose(got.blocks.numpy(), whole.blocks.numpy(),
                               **(F64 if dtype == np.float64 else TOL))
    want = scipy_square(s)
    want.eliminate_zeros()
    c = got.to_scipy().tocsr()
    c.eliminate_zeros()
    c.sort_indices()
    np.testing.assert_array_equal(c.indptr, want.indptr)
    np.testing.assert_allclose(c.data, want.data,
                               **(F64 if dtype == np.float64 else TOL))


@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_spgemm_bsr_same_csr_as_reference(name):
    sa, sb = BLOCKED[name]()
    ja, jb = JCSR.from_scipy(sa), JCSR.from_scipy(sb)
    want = jbsr.spgemm_bsr(ja, jb)
    got = T.spgemm(bridge(ja), bridge(jb), method="bsr", trim=False)
    same_csr(got, want)


def test_spgemm_bsr_float64_against_scipy():
    s = jgen.banded(1024, 6, seed=11).astype(np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    got = tbsr.spgemm_bsr(a, a)
    assert got.vals.dtype == torch.float64
    want = scipy_square(s)
    want.eliminate_zeros()  # spgemm_bsr drops zeros inside blocks
    assert_csr_vs_scipy(got, want, **F64)


def test_spgemm_bsr_drops_cancelled_entries_like_the_reference():
    # (A @ A)[0, 1] = 1 * 1 + 1 * (-1) = 0: a zero inside a block
    d = np.zeros((128, 128), np.float32)
    d[0, 0] = d[0, 1] = d[0, 2] = 1.0
    d[2, 1] = -1.0
    d[5, 5] = 2.0
    s = sp.csr_matrix(d)
    want = jbsr.spgemm_bsr(JCSR.from_scipy(s), JCSR.from_scipy(s))
    got = tbsr.spgemm_bsr(T.CSR.from_scipy(s, device="cpu"),
                          T.CSR.from_scipy(s, device="cpu"))
    same_csr(got, want)


@pytest.mark.parametrize("name", ["banded_1024", "dense_rows_256"])
def test_bsr_density_and_gate_match_reference(name):  # C = A @ A gates
    sa, _ = BLOCKED[name]()
    ja = JCSR.from_scipy(sa)
    ta = bridge(ja)
    assert tbsr.block_density(ta) == jbsr.block_density(ja)
    assert tbsr.bsr_viable(ta) == jbsr.bsr_viable(ja)


# ---- dense ------------------------------------------------------------------


def _random(m, density, seed, dtype=np.float32):
    return sp.random(m, m, density=density, random_state=seed, format="csr",
                     dtype=dtype)


DENSE = {  # one matrix per extraction mode
    "identity": lambda: _random(40, 0.6, 1),
    "shift": lambda: _random(64, 0.2, 2),
    "scan": lambda: jgen.poisson2d(16),
}


@pytest.mark.parametrize("mode", sorted(DENSE))
def test_dense_plan_fields_equal_reference(mode):
    ja = JCSR.from_scipy(DENSE[mode]())
    ta = bridge(ja)
    jp = jdense.make_dense_plan(ja, ja)
    tp = tdense.make_dense_plan(ta, ta)
    assert jp.mode == tp.mode == mode
    assert (tp.nnz_c, tp.cap_c, tp.disp_bits, tp.shape) == (
        jp.nnz_c, jp.cap_c, jp.disp_bits, jp.shape)
    np.testing.assert_array_equal(tp.rowptr.numpy(), np.asarray(jp.rowptr))
    np.testing.assert_array_equal(tp.colidx.numpy(), np.asarray(jp.colidx))
    # scan keys: uint32 there, int64 here, the same values
    np.testing.assert_array_equal(tp.p1.numpy().astype(np.int64),
                                  np.asarray(jp.p1).astype(np.int64))
    np.testing.assert_array_equal(tp.p2.numpy(), np.asarray(jp.p2))


@pytest.mark.parametrize("mode", sorted(DENSE))
def test_spgemm_dense_same_csr_as_reference(mode):
    ja = JCSR.from_scipy(DENSE[mode]())
    ta = bridge(ja)
    want = jdense.spgemm_dense(ja, ja, jdense.make_dense_plan(ja, ja))
    got = T.spgemm(ta, ta, method="dense", trim=False)
    same_csr(got, want)


def test_spgemm_dense_rectangular():
    sa = sp.random(48, 80, density=0.1, random_state=5, format="csr",
                   dtype=np.float32)
    sb = sp.random(80, 56, density=0.1, random_state=6, format="csr",
                   dtype=np.float32)
    ja, jb = JCSR.from_scipy(sa), JCSR.from_scipy(sb)
    want = jdense.spgemm_dense_auto(ja, jb)
    same_csr(tdense.spgemm_dense_auto(bridge(ja), bridge(jb)), want)


def test_spgemm_dense_keeps_cancelled_entries():
    # (A @ A)[0, 1] = 1 * 1 + 1 * (-1) = 0 stays an explicit zero
    d = np.zeros((4, 4), np.float32)
    d[0, 0] = d[0, 2] = d[0, 1] = 1.0
    d[2, 1] = -1.0
    s = sp.csr_matrix(d)
    ja = JCSR.from_scipy(s)
    want = jdense.spgemm_dense_auto(ja, ja)
    got = tdense.spgemm_dense_auto(bridge(ja), bridge(ja))
    same_csr(got, want)
    assert 0.0 in got.vals.numpy()[: int(got.rowptr[-1])]


@pytest.mark.parametrize("mode", sorted(DENSE))
def test_spgemm_dense_float64_against_scipy(mode):
    s = DENSE[mode]().astype(np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    got = tdense.spgemm_dense_auto(a, a)
    assert got.vals.dtype == torch.float64
    assert_csr_vs_scipy(got, scipy_square(s), **F64)


def test_csr_to_dense_is_the_reference_dense():
    ja = JCSR.from_scipy(_random(30, 0.2, 9))
    np.testing.assert_array_equal(tdense.csr_to_dense(bridge(ja)).numpy(),
                                  np.asarray(jdense.csr_to_dense(ja)))


def test_ieee_fp32_restores_the_callers_setting():
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        with tdense.ieee_fp32():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = old
