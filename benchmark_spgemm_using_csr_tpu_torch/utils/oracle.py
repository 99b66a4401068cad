"""Scipy-based golden reference + tolerance-aware CSR comparator (the
stand-in for the reference benchmark's serial CPU SpGEMM check: nnzC,
column indices, then values within FP tolerance)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.csr import CSR

# the CLI's verify tolerances by value type (the reference CLI's); a
# bfloat16 product is held against the float32 golden of the rounded inputs
TOLERANCES = {
    "float32": dict(rtol=1e-4, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=1e-2),
    "float64": dict(rtol=1e-12, atol=1e-14),
}


def canonical(c) -> sp.csr_matrix:
    """C (a CSR or BSR of this package on any device, or a scipy matrix) as
    a host scipy CSR with duplicates summed and columns sorted; a scipy
    input is copied."""
    c_sp = c.tocsr(copy=True) if sp.issparse(c) else c.to_scipy().tocsr()
    c_sp.sum_duplicates()
    c_sp.sort_indices()
    return c_sp


def spgemm_reference(*factors):
    """Golden product of the factors (CSRs of this package or scipy
    matrices; usually A, B) via scipy, canonical. scipy drops entries whose
    sum is exactly 0. bfloat16 operands enter as float32
    (``CSR.to_scipy``), so the golden is scipy's float32 product of the
    rounded inputs."""
    mats = [f if sp.issparse(f) else f.to_scipy() for f in factors]
    c = mats[0]
    for f in mats[1:]:
        c = c @ f
    return canonical(c)


def _keys(c_sp) -> np.ndarray:
    rows = np.repeat(np.arange(c_sp.shape[0], dtype=np.int64),
                     np.diff(c_sp.indptr))
    return rows * c_sp.shape[1] + c_sp.indices


def _eps(got) -> float:
    """The machine epsilon of C's value type (a CSR's, a BSR's or
    scipy's)."""
    if sp.issparse(got):
        return float(np.finfo(got.dtype).eps)
    vals = got.blocks if hasattr(got, "blocks") else got.vals
    return float(torch.finfo(vals.dtype).eps)


def cancellation_bound(factors, keys, ncols: int, eps: float) -> np.ndarray:
    """For each entry (flat key row * ncols + col) of the product of the
    scipy ``factors``: k * eps * sum|terms|, with k the entry's count of
    terms (paths through the factors' structures) and sum|terms| the entry
    of |F1| @ |F2| @ ... . Each of two sums of those terms, in any order of
    addition, lies within k * eps / 2 * sum|terms| of the exact one
    (Higham's gamma_k), so two results may differ by this much; an entry
    outside the product's structure gets 0. Only the keys' rows are
    multiplied."""
    rows, local = np.unique(keys // ncols, return_inverse=True)
    cols = keys % ncols
    mags = [abs(f).tocsr() for f in factors]
    paths = [(f != 0).astype(np.float64).tocsr() for f in factors]
    w, k = mags[0][rows], paths[0][rows]
    for m, p in zip(mags[1:], paths[1:]):
        w, k = w @ m, k @ p
    w = np.asarray(w.tocsr()[local, cols], np.float64).ravel()
    k = np.asarray(k.tocsr()[local, cols], np.float64).ravel()
    return k * eps * w


def assert_csr_equal(got, want, rtol=1e-5, atol=1e-6,
                     check_explicit_zeros=True, factors=None) -> int:
    """Compare C (a CSR or BSR of this package, or a scipy matrix) against
    a scipy ``want``: rowptr and colidx exactly, values within FP
    tolerance. With ``check_explicit_zeros=False`` both sides are pruned
    of exact zeros first.

    factors: the scipy operands whose product ``want`` is (A, B or R, A,
    P). With them, a sum that cancels may round to exactly 0 on one side
    and to a residue on the other: an entry may then lie in one structure
    only when its value is within ``cancellation_bound`` of 0 at C's
    value type. Returns the count of such entries (0 without factors);
    raises AssertionError."""
    got_sp, want = canonical(got), canonical(want)
    if not check_explicit_zeros:
        got_sp.eliminate_zeros()
        want.eliminate_zeros()
    assert got_sp.shape == want.shape, (got_sp.shape, want.shape)
    same = (np.array_equal(got_sp.indptr, want.indptr)
            and np.array_equal(got_sp.indices, want.indices))
    if same or factors is None:
        np.testing.assert_array_equal(
            got_sp.indptr, want.indptr, err_msg="rowptr mismatch"
        )
        np.testing.assert_array_equal(
            got_sp.indices, want.indices, err_msg="colidx mismatch"
        )
        np.testing.assert_allclose(
            got_sp.data, want.data, rtol=rtol, atol=atol,
            err_msg="value mismatch"
        )
        return 0
    k_got, k_want = _keys(got_sp), _keys(want)
    keys = np.union1d(k_got, k_want)
    at_got, at_want = (np.searchsorted(keys, k_got),
                       np.searchsorted(keys, k_want))
    v_got = np.zeros(keys.size)
    v_want = np.zeros(keys.size)
    v_got[at_got] = got_sp.data
    v_want[at_want] = want.data
    seen = np.zeros(keys.size, np.int8)
    seen[at_got] += 1
    seen[at_want] += 1
    one_side = np.flatnonzero(seen == 1)
    value = np.abs(v_got[one_side] + v_want[one_side])
    bound = cancellation_bound(factors, keys[one_side], want.shape[1],
                               _eps(got))
    off = value > bound
    if off.any():
        raise AssertionError(
            f"structure mismatch: {int(off.sum())} of {one_side.size} "
            f"entries in one structure only are off 0 by more than their "
            f"sums' rounding bound (first at flat key "
            f"{int(keys[one_side][off][0])}: "
            f"|value| {value[off][0]:.3g} > {bound[off][0]:.3g})")
    np.testing.assert_allclose(v_got, v_want, rtol=rtol, atol=atol,
                               err_msg="value mismatch")
    return int(one_side.size)


def random_csr(m, n, density=0.01, dtype=np.float32, seed=0, *,
               device) -> CSR:
    """A uniformly random (m, n) CSR with standard-normal values, the
    reference's ``random_csr`` on ``device`` (a required keyword, as in
    ``CSR.from_scipy``)."""
    rng = np.random.default_rng(seed)
    mat = sp.random(
        m, n, density=density, format="csr", dtype=np.float64, random_state=rng
    )
    mat.data = rng.standard_normal(mat.nnz)
    return CSR.from_scipy(mat.astype(dtype), device=device)
