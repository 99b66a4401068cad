"""Scipy-based golden reference + tolerance-aware CSR comparator (the
stand-in for the reference benchmark's serial CPU SpGEMM check: nnzC,
column indices, then values within FP tolerance)."""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR

# the CLI's verify tolerances by value type (the reference CLI's); a
# bfloat16 product is held against the float32 golden of the rounded inputs
TOLERANCES = {
    "float32": dict(rtol=1e-4, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=1e-2),
    "float64": dict(rtol=1e-12, atol=1e-14),
}


def spgemm_reference(a: CSR, b: CSR):
    """Golden C = A @ B via scipy (canonical: sorted cols, no duplicates;
    explicit zeros from cancellation are kept, as merge-based SpGEMM keeps
    them). bfloat16 operands enter as float32 (``CSR.to_scipy``), so the
    golden is scipy's float32 product of the rounded inputs."""
    c = (a.to_scipy() @ b.to_scipy()).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def assert_csr_equal(got: CSR, want, rtol=1e-5, atol=1e-6,
                     check_explicit_zeros=True):
    """Compare a CSR of this package against a scipy CSR: rowptr and
    colidx exactly, values within FP tolerance. With
    ``check_explicit_zeros=False`` both sides are pruned first."""
    got_sp = got.to_scipy()
    got_sp.sum_duplicates()
    got_sp.sort_indices()
    want = want.tocsr()
    want.sum_duplicates()
    want.sort_indices()
    if not check_explicit_zeros:
        got_sp.eliminate_zeros()
        want = want.copy()
        want.eliminate_zeros()
    assert got_sp.shape == want.shape, (got_sp.shape, want.shape)
    np.testing.assert_array_equal(
        got_sp.indptr, want.indptr, err_msg="rowptr mismatch"
    )
    np.testing.assert_array_equal(
        got_sp.indices, want.indices, err_msg="colidx mismatch"
    )
    np.testing.assert_allclose(
        got_sp.data, want.data, rtol=rtol, atol=atol, err_msg="value mismatch"
    )

