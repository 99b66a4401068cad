"""ILU(0) factorization and preconditioned CG, after the reference
package's ``models/ilu0.py``.

The classic Gaussian-elimination ILU0 is sequential per row. This is the
fine-grained iterative ILU (Chow & Patel, SIAM J. Sci. Comput. 2015):
every nonzero's equation

    l_ij = (a_ij - sum_{k<j} l_ik u_kj) / u_jj        (i > j)
    u_ij =  a_ij - sum_{k<i} l_ik u_kj                (i <= j)

is relaxed in parallel as a fixed-point sweep: each sweep is one gather
and a masked dot per nonzero. Setup (host, one-time symbolic phase, copied
from the reference) precomputes for every stored (i, j) the list of
(position of l_ik, position of u_kj) dependency pairs, padded to the max
count. The reference's ``lax.scan`` over the sweeps is a Python loop of
tensor ops here, captured as one CUDA graph per sweep count on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.spmv import spmv
from ..sparse.csr import CSR


@dataclasses.dataclass(frozen=True)
class ILU0Plan:
    """Host-precomputed symbolic structure for the Chow-Patel sweeps."""

    dep_l: np.ndarray  # (nnz, max_deps) positions into vals (l_ik)
    dep_u: np.ndarray  # (nnz, max_deps) positions into vals (u_kj)
    dep_mask: np.ndarray  # (nnz, max_deps) bool
    diag_pos: np.ndarray  # (m,) position of the diagonal entry of each row
    is_lower: np.ndarray  # (nnz,) bool: strictly lower triangular
    row_of: np.ndarray  # (nnz,) row index
    col_of: np.ndarray  # (nnz,) col index


def ilu0_plan(a_sp: sp.csr_matrix) -> ILU0Plan:
    a_sp = a_sp.tocsr()
    a_sp.sort_indices()
    m = a_sp.shape[0]
    indptr, indices = a_sp.indptr, a_sp.indices
    nnz = indptr[-1]
    pos_of = {}
    for i in range(m):
        for t in range(indptr[i], indptr[i + 1]):
            pos_of[(i, indices[t])] = t
    diag_pos = np.array([pos_of.get((i, i), -1) for i in range(m)], np.int64)
    if (diag_pos < 0).any():
        raise ValueError("ILU0 requires a full diagonal")

    deps_l, deps_u = [], []
    row_of = np.zeros(nnz, np.int32)
    col_of = np.zeros(nnz, np.int32)
    for i in range(m):
        row_cols = indices[indptr[i] : indptr[i + 1]]
        row_pos = {int(c): int(indptr[i] + t) for t, c in enumerate(row_cols)}
        for t in range(indptr[i], indptr[i + 1]):
            j = int(indices[t])
            row_of[t], col_of[t] = i, j
            kmax = min(i, j)
            dl, du = [], []
            # k ranges over columns of row i below kmax that also appear in
            # column j's pattern, i.e. (k, j) stored.
            for k in row_cols:
                k = int(k)
                if k >= kmax:
                    break
                ukj = pos_of.get((k, j))
                if ukj is not None:
                    dl.append(row_pos[k])
                    du.append(ukj)
            deps_l.append(dl)
            deps_u.append(du)
    max_deps = max((len(d) for d in deps_l), default=0)
    max_deps = max(max_deps, 1)
    dep_l = np.zeros((nnz, max_deps), np.int64)
    dep_u = np.zeros((nnz, max_deps), np.int64)
    dep_mask = np.zeros((nnz, max_deps), bool)
    for t, (dl, du) in enumerate(zip(deps_l, deps_u)):
        dep_l[t, : len(dl)] = dl
        dep_u[t, : len(du)] = du
        dep_mask[t, : len(dl)] = True
    is_lower = row_of > col_of
    return ILU0Plan(dep_l, dep_u, dep_mask, diag_pos, is_lower, row_of, col_of)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """The static of the sweeps' body: their count, as the reference's
    ``_sweep`` is keyed on ``sweeps``."""

    sweeps: int


def _sweep(vals0, dep_l, dep_u, dep_mask, diag_pos, is_lower, col_of,
           plan: SweepPlan):
    """``plan.sweeps`` Jacobi-style relaxations of every factor entry at
    once, from A's values ``vals0``."""
    vals = vals0
    for _ in range(plan.sweeps):
        s = torch.where(dep_mask, vals[dep_l] * vals[dep_u], 0).sum(dim=1)
        u_diag = vals[diag_pos]
        new_u = vals0 - s
        vals = torch.where(is_lower, new_u / u_diag[col_of], new_u)
    return vals


def ilu0(a: CSR, sweeps: int = 10, plan: ILU0Plan | None = None) -> CSR:
    """Compute the ILU0 factorization on ``a``'s device; returns a CSR
    holding L (strictly lower, unit diagonal implied) and U (upper incl.
    diagonal) in A's sparsity pattern, the usual combined storage. The
    sweeps replay one CUDA graph per (sweep count, shapes) on the card
    from the second call (``ops/graphs``); the plan and the factor's way
    back stay on the host, as in the reference."""
    from ..ops import graphs

    a_sp = a.to_scipy()
    plan = plan or ilu0_plan(a_sp)
    dev = a.device

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    vals = graphs.run(
        _sweep, SweepPlan(sweeps), up(a_sp.data), up(plan.dep_l),
        up(plan.dep_u), up(plan.dep_mask), up(plan.diag_pos),
        up(plan.is_lower), up(plan.col_of.astype(np.int64)),
    )
    out = a_sp.copy()
    out.data = vals.cpu().numpy()
    return CSR.from_scipy(out, capacity=a.capacity, device=dev)


def split_lu(f: CSR):
    """Split combined ILU0 storage into scipy L (unit diag) and U."""
    f_sp = f.to_scipy()
    coo = f_sp.tocoo()
    lower = coo.row > coo.col
    l = sp.coo_matrix(
        (coo.data[lower], (coo.row[lower], coo.col[lower])), shape=f_sp.shape
    ).tocsr() + sp.identity(f_sp.shape[0], f_sp.dtype, format="csr")
    upper = ~lower
    u = sp.coo_matrix(
        (coo.data[upper], (coo.row[upper], coo.col[upper])), shape=f_sp.shape
    ).tocsr()
    return l, u


def ilu0_apply(f: CSR, r, iters: int = 20):
    """Apply the ILU0 preconditioner: z = U^{-1} L^{-1} r via Jacobi
    triangular solves on the combined-storage factor ``f``."""
    from .amg import diag_of

    # keep combined storage and mask per solve:
    # L = I + strictly-lower(f), U = upper(f) incl. diagonal.
    row = f.row_ids()
    rc = torch.clamp(row, max=f.m - 1)
    low_mask = (f.colidx < rc) & (row < f.m)
    up_mask = (f.colidx >= rc) & (row < f.m)
    l = CSR(f.rowptr, f.colidx, torch.where(low_mask, f.vals, 0), f.shape)
    u = CSR(f.rowptr, f.colidx, torch.where(up_mask, f.vals, 0), f.shape)

    # L y = r with unit diagonal: y_{k+1} = r - L_strict y_k
    y = r
    for _ in range(iters):
        y = r - spmv(l, y)
    # U z = y: z_{k+1} = z + D^{-1}(y - U z)
    dinv = 1.0 / diag_of(u)
    z = dinv * y
    for _ in range(iters):
        z = z + dinv * (y - spmv(u, z))
    return z


def pcg(a: CSR, b, f: CSR | None = None, tol: float = 1e-6, max_iters: int = 200,
        solve_iters: int = 20, precond: str = "jacobi"):
    """Preconditioned conjugate gradients with the ILU0 factor ``f`` as
    M ≈ A (plain CG when f is None).

    ``precond="jacobi"`` applies M^{-1} with fixed-count Jacobi triangular
    sweeps (`ilu0_apply`); ``precond="exact"`` uses the level-scheduled
    exact SpTRSV (`ops.sptrsv.ilu0_apply_exact`) with schedules built once
    from f's structure and reused every iteration. ``b`` is a tensor on
    ``a``'s device."""
    if f is not None and precond == "exact":
        from ..ops.sptrsv import ilu0_apply_exact, make_trsv_plan

        sched_l = make_trsv_plan(f, lower=True, unit_diag=True)
        sched_u = make_trsv_plan(f, lower=False)
        apply_m = lambda r: ilu0_apply_exact(f, r, sched_l, sched_u)
    elif f is not None:
        if precond != "jacobi":
            raise ValueError(f"unknown precond {precond!r}; use 'jacobi' or 'exact'")
        apply_m = lambda r: ilu0_apply(f, r, solve_iters)

    x = torch.zeros_like(b)
    r = b - spmv(a, x)
    z = apply_m(r) if f is not None else r
    p = z
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.norm(b))
    history = []
    for _ in range(max_iters):
        rnorm = float(torch.linalg.norm(r))
        history.append(rnorm / bnorm)
        if rnorm / bnorm < tol:
            break
        ap = spmv(a, p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r) if f is not None else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x.cpu().numpy(), history


def ilu0_residual_on_pattern(a: CSR, f: CSR) -> float:
    """max |(L U - A)_ij| over the pattern of A, the ILU0 defining property."""
    l, u = split_lu(f)
    a_sp = a.to_scipy()
    prod = (l @ u).tocsr()
    mask = a_sp.copy()
    mask.data = np.ones_like(mask.data)
    diff = (prod.multiply(mask) - a_sp)
    return float(np.abs(diff.data).max()) if diff.nnz else 0.0
