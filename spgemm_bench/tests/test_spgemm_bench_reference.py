"""The plain reference against scipy at small sizes, and its AMG against
the program's set-up."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spgemm_bench.generators import circuit, poisson2d
from spgemm_bench.reference import amg, compare, sparse


def _mat(m):
    m = m.tocsr()
    m.sort_indices()
    return sparse.from_arrays(m.indptr, m.indices, m.data, m.shape, "cpu")


def _random(m, n, density, seed):
    return sp.random(m, n, density=density, random_state=seed,
                     format="csr", dtype=np.float64,
                     data_rvs=np.random.default_rng(seed).standard_normal)


def _assert_equal(got: sparse.Mat, want):
    want = want.tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(got.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.colidx.numpy(), want.indices)
    np.testing.assert_allclose(got.vals.numpy(), want.data, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("budget", [1 << 25, 37])
def test_product_equals_scipy(budget):
    a = _random(300, 200, 0.03, 1)
    b = _random(200, 250, 0.05, 2)
    c, products = sparse.spgemm(_mat(a), _mat(b), budget=budget)
    pa = (a != 0).astype(np.int64)
    pb = (b != 0).astype(np.int64)
    structural = pa @ pb  # keeps entries whose values cancel
    assert products == int(structural.sum())
    assert c.nnz == structural.nnz
    _assert_equal(c, a @ b)
    absv = (abs(a) @ abs(b)).tocsr()
    absv.sort_indices()
    np.testing.assert_allclose(c.absv.numpy(), absv.data, rtol=1e-12)


def test_product_on_the_circuit_and_stencil_generators():
    for rowptr, colidx, vals, shape in (circuit.generate(n=2048, seed=0),
                                        poisson2d.generate(k=20)):
        a = sp.csr_matrix((vals.astype(np.float64), colidx, rowptr),
                          shape=shape)
        c, _ = sparse.spgemm(_mat(a), _mat(a), budget=4096)
        _assert_equal(c, a @ a)


def test_transpose_and_add_equal_scipy():
    a = _random(120, 90, 0.05, 3)
    b = _random(120, 90, 0.05, 4)
    _assert_equal(sparse.transpose(_mat(a)), a.T)
    _assert_equal(sparse.add(_mat(a), _mat(b), 2.0, -0.5), 2.0 * a - 0.5 * b)
    z = sparse.add(_mat(a), _mat(a), 1.0, -1.0, drop_zeros=True)
    assert z.nnz == 0


def test_bfloat16_rounds_the_inputs():
    a = _random(50, 50, 0.1, 5)
    c64, _ = sparse.spgemm(_mat(a), _mat(a))
    c16, _ = sparse.spgemm(_mat(a), _mat(a), precision="bfloat16")
    assert c16.vals.dtype == torch.float32
    assert torch.equal(c16.colidx, c64.colidx)
    r = compare.compare(c16.rowptr, c16.colidx, c16.vals, c64)
    assert 1e-4 < r["val_err"] < 2e-2


def test_compare_reads_structure_then_values():
    a = _random(60, 60, 0.1, 6)
    c, _ = sparse.spgemm(_mat(a), _mat(a))
    ok = compare.compare(c.rowptr.int(), c.colidx.int(), c.vals.float(), c)
    assert ok["struct_mismatch"] == 0 and ok["val_err"] < 1e-6
    col = c.colidx.clone()
    col[3] = (col[3] + 1) % 60
    assert compare.compare(c.rowptr, col, c.vals, c)["struct_mismatch"] == 1
    ptr = c.rowptr.clone()
    ptr[1:5] += 1
    bad = compare.compare(ptr, c.colidx, c.vals, c)
    assert bad["struct_mismatch"] >= 1 and bad["val_err"] == float("inf")
    vals = c.vals.clone()
    vals[0] *= 1.001
    assert compare.compare(c.rowptr, c.colidx, vals, c)["val_err"] > 1e-4
    vals[0] = float("nan")
    assert compare.compare(c.rowptr, c.colidx, vals, c)["val_err"] == \
        float("inf")


def test_aggregation_equals_the_programs():
    from benchmark_spgemm_using_csr_tpu_torch.models import amg as prog

    rowptr, colidx, vals, shape = poisson2d.generate(k=30)
    a = sp.csr_matrix((vals, colidx, rowptr), shape=shape)
    p = prog.aggregation_prolongator(a)
    agg, count = amg.aggregate(rowptr, colidx, vals)
    assert count == p.shape[1]
    np.testing.assert_array_equal(agg, p.indices)


def test_smoothed_hierarchy_equals_the_programs():
    """The reference's P, R and R·A·P against the program's build_hierarchy
    on the stencil (two levels, smoothed)."""
    from benchmark_spgemm_using_csr_tpu_torch.models import amg as prog

    rowptr, colidx, vals, shape = poisson2d.generate(k=24)
    a_sp = sp.csr_matrix((vals, colidx, rowptr), shape=shape)
    h = prog.build_hierarchy(a_sp, max_levels=2, smooth=True, device="cpu")
    ref = amg.hierarchy(_mat(a_sp), 2, smooth=True)
    assert len(ref.p) == len(h.levels) - 1 == 1
    _assert_close(ref.p[0], h.levels[1].p)
    _assert_close(ref.r[0], h.levels[1].r)
    coarse, counts = amg.coarse_operators(ref, _mat(a_sp))
    _assert_close(coarse[0], h.levels[1].a)
    assert counts[0][0] > 0 and counts[0][1] > 0


def _assert_close(ref: sparse.Mat, got):
    r = compare.compare(got.rowptr, got.colidx, got.vals, ref)
    assert r["struct_mismatch"] == 0 and r["val_err"] < 1e-5
