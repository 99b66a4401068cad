"""Algebraic multigrid (AMG) on the SpGEMM substrate, after the reference
package's ``models/amg.py``: the Galerkin triple product R·A·P for a level
hierarchy, chained SpGEMMs, structure reuse for a numeric refresh, and a
V-cycle solver.

Setup (aggregation) is host numpy, a one-time symbolic phase copied from
the reference; the numeric work (R·A·P, smoothing, residuals) runs on the
device of the operands. The entry points that take a scipy matrix
(``build_hierarchy``, ``solve``) take a ``device``, the card unless the
caller names another, and raise when it asks for a card that is not there.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..api import spgemm
from ..ops.spmv import spmv
from ..ops.stream import scatter
from ..sparse.csr import CSR, csr_transpose
from ..utils import profiling


def _device(device) -> torch.device:
    """The device a scipy input goes to; a card that is not there raises
    (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available")
    return dev


def aggregation_prolongator(a_sp: sp.csr_matrix, strength: float = 0.25) -> sp.csr_matrix:
    """Greedy standard aggregation: partition nodes into aggregates over the
    strength graph; P[i, agg(i)] = 1 (piecewise-constant prolongation)."""
    n = a_sp.shape[0]
    # strength graph: |a_ij| >= strength * sqrt(|a_ii a_jj|)
    d = np.abs(a_sp.diagonal())
    d[d == 0] = 1.0
    coo = a_sp.tocoo()
    mask = (coo.row != coo.col) & (
        np.abs(coo.data) >= strength * np.sqrt(d[coo.row] * d[coo.col])
    )
    g = sp.csr_matrix(
        (np.ones(mask.sum()), (coo.row[mask], coo.col[mask])), shape=a_sp.shape
    )
    agg = np.full(n, -1, np.int64)
    next_agg = 0
    # pass 1: root aggregates from fully-unassigned neighborhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = g.indices[g.indptr[i] : g.indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # pass 2: attach leftovers to a neighboring aggregate (or make singleton)
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = g.indices[g.indptr[i] : g.indptr[i + 1]]
        assigned = nbrs[agg[nbrs] != -1]
        if assigned.size:
            agg[i] = agg[assigned[0]]
        else:
            agg[i] = next_agg
            next_agg += 1
    p = sp.csr_matrix(
        (np.ones(n, a_sp.dtype), (np.arange(n), agg)), shape=(n, next_agg)
    )
    return p


def galerkin_product(a: CSR, p: CSR, r: CSR | None = None) -> CSR:
    """Coarse operator A_c = R · A · P (R = P^T unless given) via two chained
    SpGEMMs on the device."""
    r = r if r is not None else csr_transpose(p)
    ap = spgemm(a, p)
    return spgemm(r, ap)


def numeric_refresh(h: "AMGHierarchy", a_new: CSR) -> "AMGHierarchy":
    """Recompute every level's coarse operator for NEW VALUES in the same
    fine-grid structure (Jacobian refills on a fixed mesh, time-dependent
    coefficients).

    Takes ops/aggrap when the level's P is a piecewise-constant
    aggregation (the unsmoothed setup's P), else the cached fused triple
    plan (ops/reuse), else, when the triple stream is too large, the two
    chained products. Plans are cached on the hierarchy; the first refresh
    builds them. On the card each level's product replays one CUDA graph
    from the second refresh on (``ops/graphs``).
    """
    from ..ops.aggrap import make_aggrap_plan, rap_aggregation
    from ..ops.reuse import make_triple_plan, spgemm_triple

    with profiling.span("amg.refresh"):
        if not hasattr(h, "_triple_plans"):
            h._triple_plans = [None] * len(h.levels)
        levels = [Level(a=a_new, p=None, r=None)]
        cur = a_new
        for li in range(1, len(h.levels)):
            p, r = h.levels[li].p, h.levels[li].r
            if h._triple_plans[li] is None:
                asched = make_aggrap_plan(r, cur, p)
                h._triple_plans[li] = (
                    ("agg", asched) if asched is not None
                    else ("triple", make_triple_plan(r, cur, p))
                )
            kind, sched = h._triple_plans[li]
            if kind == "agg":
                a_c = rap_aggregation(cur, sched)
            elif sched is not None:
                a_c = spgemm_triple(r, cur, p, sched)
            else:  # triple stream too large: chain the two products
                a_c = galerkin_product(cur, p, r)
            levels.append(Level(a=a_c, p=p, r=r))
            cur = a_c
        out = AMGHierarchy(levels)
        out._triple_plans = h._triple_plans
        return out


@dataclasses.dataclass
class Level:
    a: CSR
    p: CSR | None = None  # prolongation to this level's fine grid
    r: CSR | None = None


@dataclasses.dataclass
class AMGHierarchy:
    levels: List[Level]

    def save(self, prefix: str) -> None:
        """Persist all levels, in the reference package's files."""
        for i, lv in enumerate(self.levels):
            lv.a.save(f"{prefix}.L{i}.A.npz")
            if lv.p is not None:
                lv.p.save(f"{prefix}.L{i}.P.npz")

    @staticmethod
    def load(prefix: str, n_levels: int, *, device) -> "AMGHierarchy":
        levels = []
        for i in range(n_levels):
            a = CSR.load(f"{prefix}.L{i}.A.npz", device=device)
            p = None
            try:
                p = CSR.load(f"{prefix}.L{i}.P.npz", device=device)
            except FileNotFoundError:
                pass
            levels.append(Level(a=a, p=p, r=csr_transpose(p) if p else None))
        return AMGHierarchy(levels)


def smooth_prolongator(a: CSR, p: CSR, omega: float = 0.67) -> CSR:
    """Smoothed aggregation: P_s = (I - ω D⁻¹ A) P, one extra SpGEMM per
    level on the device; the difference is taken on the host (scipy), as
    in the reference."""
    dinv = 1.0 / diag_of(a)
    # scale A's rows by ω D⁻¹ (elementwise on vals via row ids)
    row = torch.clamp(a.row_ids(), max=a.m - 1).long()
    a_scaled = CSR(
        a.rowptr, a.colidx, (omega * dinv)[row] * a.vals, a.shape
    )
    ap = spgemm(a_scaled, p)
    # P - (ω D⁻¹ A) P via CSR addition on the host (setup phase, one-time)
    diff = (p.to_scipy() - ap.to_scipy()).tocsr()
    diff.eliminate_zeros()
    diff.sort_indices()
    return CSR.from_scipy(diff, device=a.device)


def build_hierarchy(
    a_sp: sp.csr_matrix,
    max_levels: int = 10,
    min_coarse: int = 64,
    smooth: bool = True,
    *,
    device="cuda",
) -> AMGHierarchy:
    """Setup: aggregate, (optionally) smooth P, compute A_c = R A P per
    level: three chained SpGEMMs per level on the device when smoothing."""
    dev = _device(device)
    levels = [Level(a=CSR.from_scipy(a_sp, device=dev))]
    cur_sp = a_sp
    while len(levels) < max_levels and cur_sp.shape[0] > min_coarse:
        p_sp = aggregation_prolongator(cur_sp)
        if p_sp.shape[1] >= cur_sp.shape[0]:  # no coarsening progress
            break
        p = CSR.from_scipy(p_sp, device=dev)
        if smooth:
            p = smooth_prolongator(levels[-1].a, p)
        r = csr_transpose(p)
        a_c = galerkin_product(levels[-1].a, p, r)
        levels.append(Level(a=a_c, p=p, r=r))
        cur_sp = a_c.to_scipy()
    return AMGHierarchy(levels)


def _jacobi(a: CSR, diag_inv, x, b, omega=0.67):
    return x + omega * diag_inv * (b - spmv(a, x))


def diag_of(a: CSR) -> torch.Tensor:
    """The diagonal of a CSR (entries off the diagonal go to the dump
    slot)."""
    row = a.row_ids()
    is_diag = (a.colidx == torch.clamp(row, max=a.m - 1)) & (row < a.m)
    return scatter(a.m, torch.where(is_diag, a.colidx, a.m), a.vals,
                   accumulate=True)


def _coarse_solve(h: AMGHierarchy, a: CSR, b):
    """The coarsest level's dense direct solve. Its LU factors are made on
    the device once per hierarchy and level object, and reused by every
    V-cycle; the reference refactors ``a.todense()`` on each. The smoothed
    hierarchy stops coarsening after one level (aggregation of the smoothed
    operator makes no progress at strength 0.25), so its coarsest level can
    hold tens of thousands of rows (87604 on mc2depi_524k)."""
    from ..ops.dense import csr_to_dense

    cached = getattr(h, "_coarse_lu", None)
    if cached is None or cached[0] is not a:
        lu, pivots = torch.linalg.lu_factor(csr_to_dense(a))
        cached = h._coarse_lu = (a, lu, pivots)
    _, lu, pivots = cached
    return torch.linalg.lu_solve(lu, pivots, b.to(lu.dtype)[:, None])[:, 0]


def v_cycle(h: AMGHierarchy, b, n_smooth: int = 2, level: int = 0):
    """One V-cycle for A x = b (dense direct solve at the coarsest level)."""
    a = h.levels[level].a
    if level == len(h.levels) - 1:
        return _coarse_solve(h, a, b)
    dinv = 1.0 / diag_of(a)
    x = torch.zeros_like(b)
    for _ in range(n_smooth):
        x = _jacobi(a, dinv, x, b)
    res = b - spmv(a, x)
    r_op = h.levels[level + 1].r
    b_c = spmv(r_op, res)
    e_c = v_cycle(h, b_c, n_smooth, level + 1)
    x = x + spmv(h.levels[level + 1].p, e_c)
    for _ in range(n_smooth):
        x = _jacobi(a, dinv, x, b)
    return x


def solve(
    a_sp: sp.csr_matrix,
    b: np.ndarray,
    tol: float = 1e-6,
    max_iters: int = 100,
    *,
    device="cuda",
) -> tuple[np.ndarray, list[float]]:
    """AMG-preconditioned stationary iteration (V-cycle as the solver)."""
    h = build_hierarchy(a_sp, device=device)
    a = h.levels[0].a
    bj = torch.as_tensor(np.asarray(b)).to(a.device)
    x = torch.zeros_like(bj)
    history = []
    bnorm = float(torch.linalg.norm(bj))
    for _ in range(max_iters):
        res = bj - spmv(a, x)
        rnorm = float(torch.linalg.norm(res))
        history.append(rnorm / bnorm)
        if rnorm / bnorm < tol:
            break
        x = x + v_cycle(h, res)
    return x.cpu().numpy(), history
