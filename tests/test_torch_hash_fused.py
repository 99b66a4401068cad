"""The PyTorch port's hash and fused SpGEMM paths (ops/hash.py,
ops/fused.py) against the reference package on the same seeded inputs.
Plans, tiles and structures equal exactly; float32 values within rtol 1e-4
/ atol 1e-5 (duplicates summed in another order; fused's bins go through
K2's plain version where the reference sorts with lax.sort); float64
against the x64 scipy golden at rtol / atol 1e-12."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.ops import fused as jfused
from benchmark_spgemm_using_csr_tpu.ops import hash as jhash
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen
from benchmark_spgemm_using_csr_tpu.utils.oracle import random_csr

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import fused as tfused
from benchmark_spgemm_using_csr_tpu_torch.ops import hash as thash
from benchmark_spgemm_using_csr_tpu_torch.ops import kernels

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


def cancelling():
    """A @ A with (0, 1) = 1 * 1 + 1 * (-1): an explicit zero of C."""
    d = np.zeros((6, 6), np.float32)
    d[0, 0] = d[0, 1] = d[0, 2] = 1.0
    d[2, 1] = -1.0
    d[3, 4] = d[4, 3] = 2.0
    return sp.csr_matrix(d)


PAIRS = {
    "powerlaw": lambda: (jgen.power_law(400, 400, alpha=1.9, max_deg=200,
                                        seed=8),) * 2,
    "er": lambda: (jgen.erdos_renyi(300, 300, 6.0, seed=7),) * 2,
    "poisson2d": lambda: (jgen.poisson2d(24),) * 2,
    "rectangular": lambda: (random_csr(120, 64, density=0.08, seed=3)
                            .to_scipy(),
                            random_csr(64, 200, density=0.12, seed=4)
                            .to_scipy()),
    "cancelling": lambda: (cancelling(),) * 2,
    "zero": lambda: (sp.csr_matrix((32, 32), dtype=np.float32),) * 2,
}


# ---- hash -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_hash_same_csr_as_reference(name):
    sa, sb = PAIRS[name]()
    ja, jb = JCSR.from_scipy(sa), JCSR.from_scipy(sb)
    want = jhash.spgemm_hash(ja, jb)
    got = T.spgemm(bridge(ja), bridge(jb), method="hash", trim=False)
    same_csr(got, want)


def test_hash_keeps_cancelled_entries():
    ja = JCSR.from_scipy(cancelling())
    c = thash.spgemm_hash(bridge(ja), bridge(ja))
    row0 = slice(int(c.rowptr[0]), int(c.rowptr[1]))
    assert c.colidx[row0].tolist() == [0, 1, 2]
    assert c.vals[row0].tolist() == [1.0, 0.0, 1.0]


@pytest.mark.parametrize("budget", [64 * 1024, 16 * 1024])
def test_hash_many_tiles_same_as_reference(budget):
    s = jgen.power_law(256, 256, alpha=1.8, max_deg=128, seed=5)
    ja = JCSR.from_scipy(s)
    want = jhash.spgemm_hash(ja, ja, tile_bytes_budget=budget)
    got = thash.spgemm_hash(bridge(ja), bridge(ja), tile_bytes_budget=budget)
    same_csr(got, want)


def test_hash_tile_is_the_reference_tile():
    s = jgen.power_law(300, 300, alpha=1.9, max_deg=150, seed=2)
    ja = JCSR.from_scipy(s)
    ta = bridge(ja)
    nnz_ct = np.asarray(jhash.nnz_upper_bound(ja, ja))
    rows = np.nonzero(nnz_ct > 0)[0].astype(np.int32)[5:120]
    want = jhash.hash_tile_rows(ja, ja, rows, nnz_ct)
    got = thash.hash_tile_rows(ta, ta, rows, nnz_ct)
    assert got[0].shape == np.asarray(want[0]).shape
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_hash_float64_against_scipy():
    s = jgen.power_law(300, 300, alpha=1.9, max_deg=150, seed=4,
                       dtype=np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    got = thash.spgemm_hash(a, a, tile_bytes_budget=32 * 1024)
    want = (s @ s).tocsr()
    want.sort_indices()
    nnz = want.nnz
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(got.vals.numpy()[:nnz], want.data, **F64)


# ---- fused ------------------------------------------------------------------


@pytest.mark.parametrize("widths", [(8, 32, 128, 512), (2, 8)])
@pytest.mark.parametrize("name", ["powerlaw", "er", "rectangular",
                                  "cancelling"])
def test_fused_plan_and_csr_equal_reference(name, widths):
    sa, sb = PAIRS[name]()
    ja, jb = JCSR.from_scipy(sa), JCSR.from_scipy(sb)
    ta, tb = bridge(ja), bridge(jb)
    jplan = jfused.make_plan(ja, jb, widths=widths)
    tplan = tfused.make_plan(ta, tb, widths=widths)
    assert dataclasses_tuple(tplan) == dataclasses_tuple(jplan)
    want = jfused.spgemm_fused(ja, jb, jplan)
    before = kernels.bin_sort_compress.launches
    got = tfused.spgemm_fused(ta, tb, tplan)
    assert kernels.bin_sort_compress.launches == before  # CPU: plain K2
    same_csr(got, want)


def dataclasses_tuple(plan):
    return (plan.widths, plan.bin_rows, plan.tail_rows, plan.tail_nnz_a,
            plan.tail_prod, plan.out_cap)


def test_fused_tail_rows_are_taken():
    s = jgen.power_law(400, 400, alpha=1.9, max_deg=200, seed=8)
    ja = JCSR.from_scipy(s)
    plan = tfused.make_plan(bridge(ja), bridge(ja), widths=(2, 8))
    assert plan.tail_rows > 0  # rows past 8 products take the ESC tail
    assert dataclasses_tuple(plan) == dataclasses_tuple(
        jfused.make_plan(ja, ja, widths=(2, 8)))


def test_fused_through_the_facade():
    ja = JCSR.from_scipy(jgen.SUITE["powerlaw_small"]())
    want = jfused.spgemm_fused(ja, ja, jfused.make_plan(ja, ja))
    got = T.spgemm(bridge(ja), bridge(ja), method="fused", trim=False)
    same_csr(got, want)


def test_fused_float64_against_scipy():
    s = jgen.power_law(400, 400, alpha=1.9, max_deg=200, seed=6,
                       dtype=np.float64)
    a = T.CSR.from_scipy(s, device="cpu")
    got = tfused.spgemm_fused(a, a, tfused.make_plan(a, a, widths=(4, 32)))
    want = (s @ s).tocsr()
    want.sort_indices()
    nnz = want.nnz
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(got.vals.numpy()[:nnz], want.data, **F64)


def test_rows_where_is_a_fixed_capacity_nonzero():
    mask = torch.tensor([False, True, True, False, True])
    assert tfused._rows_where(mask, 4).tolist() == [1, 2, 4, 5]
    assert tfused._rows_where(mask, 2).tolist() == [1, 2]
