"""The port's paths without a kernel of their own (bsr, dense, hash, fused,
out-of-core, SpMV/SpAdd/SpTRSV, BhSparse) on a CUDA device, against the
scipy golden at the CLI's float32 tolerances (rtol 1e-4 / atol 1e-5).
These tests need the card and skip without one; the card has no jax, so
run them there without the repository's conftest:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.utils import generators
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("method,matrix", [
    ("bsr", lambda: generators.dense_rows(2048, 2048, nnz_per_row=96)),
    ("dense", lambda: generators.dense_rows(1024, 1024, nnz_per_row=128)),
])
def test_true_fp32_under_global_tf32(method, matrix):
    """bsr and dense hold the float32 tolerance with TF32 switched on
    globally, and leave the caller's setting as they found it."""
    need_card()
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    try:
        matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        a = T.CSR.from_scipy(matrix(), device="cuda")
        c = T.spgemm(a, a, method=method)
        assert_csr_equal(c, spgemm_reference(a, a), check_explicit_zeros=False,
                         **TOL)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = old


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bsr", "dense", "hash", "fused", "esc",
                                    "chunked", "binned"])
def test_methods_on_the_card(method):
    need_card()
    s = generators.banded(1024, 9, seed=2)
    a = T.CSR.from_scipy(s, device="cuda")
    c = T.spgemm(a, a, method=method)
    assert c.vals.is_cuda
    assert_csr_equal(c, spgemm_reference(a, a), check_explicit_zeros=False,
                     **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dense", "grouped", "chunked"])
def test_batched_on_the_card(method):
    need_card()
    a = T.CSR.from_scipy(generators.erdos_renyi(600, 600, 6.0, seed=3),
                         device="cuda")
    c = T.spgemm_batched(a, a, stream_budget=4000, method=method)
    assert_csr_equal(c, spgemm_reference(a, a), **TOL)


@pytest.mark.cuda
def test_ops_on_the_card():
    need_card()
    s = generators.power_law(500, 500, alpha=2.0, max_deg=80, seed=4)
    a = T.CSR.from_scipy(s, device="cuda")
    x = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    y = T.spmv(a, torch.from_numpy(x).cuda())
    np.testing.assert_allclose(y.cpu().numpy(), s @ x, rtol=1e-4, atol=1e-4)
    c = T.spadd(a, T.csr_transpose(a))
    assert_csr_equal(c, (s + s.T).tocsr(), **TOL)
    tri = (sp.tril(s, format="csr")
           + sp.identity(500, np.float32, format="csr") * 100.0).tocsr()
    xs = T.sptrsv(T.CSR.from_scipy(tri, device="cuda"),
                  torch.from_numpy(x).cuda())
    from scipy.sparse.linalg import spsolve_triangular

    np.testing.assert_allclose(xs.cpu().numpy(),
                               spsolve_triangular(tri, x, lower=True),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_bhsparse_reports_the_card():
    need_card()
    h = T.BhSparse()
    assert h.init_platform().startswith("cuda")
    s = generators.erdos_renyi(400, 400, 5.0, seed=5)
    h.init_data(400, 400, 400, s.indptr, s.indices, s.data,
                s.indptr, s.indices, s.data)
    h.spgemm()
    rowptr, colidx, vals = h.get_c()
    want = (s @ s).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(rowptr, want.indptr)
    np.testing.assert_array_equal(colidx, want.indices)
    np.testing.assert_allclose(vals, want.data, **TOL)
