"""The plain reference of a smoothed-aggregation AMG hierarchy's coarse
operators, in NumPy (aggregation) and ``reference/sparse`` (products).

``aggregate`` is a frozen copy of ``aggregation_prolongator`` from
``benchmark_spgemm_using_csr_tpu_torch/models/amg.py`` at commit b4c7115,
rewritten on plain CSR arrays (the strength graph in NumPy, not scipy);
the greedy passes visit nodes and neighbours in the same order, so the
aggregates are the same. ``hierarchy`` follows ``build_hierarchy`` of the
same file: per level the aggregation of the current operator, the
prolongator smoothed by one damped Jacobi step, P_s = (I - ω D⁻¹ A) P,
exact zeros dropped, R = P_sᵀ and the coarse operator R·(A·P_s).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import sparse

STRENGTH = 0.25
OMEGA = 0.67


def aggregate(rowptr: np.ndarray, colidx: np.ndarray, vals: np.ndarray,
              strength: float = STRENGTH) -> tuple[np.ndarray, int]:
    """(agg, count): the aggregate of every node under greedy standard
    aggregation over the strength graph
    |a_ij| >= strength·sqrt(|a_ii a_jj|)."""
    n = len(rowptr) - 1
    rowptr = np.asarray(rowptr, np.int64)
    colidx = np.asarray(colidx, np.int64)[:rowptr[-1]]
    vals = np.asarray(vals, np.float64)[:rowptr[-1]]
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    d = np.zeros(n)
    on = row == colidx
    np.add.at(d, row[on], vals[on])
    d = np.abs(d)
    d[d == 0] = 1.0
    strong = (row != colidx) & (
        np.abs(vals) >= strength * np.sqrt(d[row] * d[colidx]))
    g_ptr = np.concatenate([[0], np.cumsum(np.bincount(row[strong],
                                                       minlength=n))])
    g_idx = colidx[strong]
    agg = np.full(n, -1, np.int64)
    count = 0
    # pass 1: root aggregates from fully unassigned neighbourhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = g_idx[g_ptr[i]:g_ptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = count
            agg[nbrs] = count
            count += 1
    # pass 2: attach leftovers to a neighbouring aggregate, or a singleton
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = g_idx[g_ptr[i]:g_ptr[i + 1]]
        assigned = nbrs[agg[nbrs] != -1]
        if assigned.size:
            agg[i] = agg[assigned[0]]
        else:
            agg[i] = count
            count += 1
    return agg, count


def prolongator(a: sparse.Mat, agg: np.ndarray, count: int,
                smooth: bool, omega: float = OMEGA) -> sparse.Mat:
    """The piecewise-constant P of ``agg``, or where ``smooth`` P_s = P -
    (ω D⁻¹ A) P, entries that sum to exactly 0 dropped."""
    dev = a.rowptr.device
    n = a.shape[0]
    p = sparse.from_arrays(np.arange(n + 1), agg, np.ones(n), (n, count),
                           dev)
    if not smooth:
        return p
    a_scaled = sparse.scale_rows(a, omega / sparse.diagonal(a))
    ap, _ = sparse.spgemm(a_scaled, p)
    return sparse.add(p, ap, 1.0, -1.0, drop_zeros=True)


@dataclasses.dataclass
class Hierarchy:
    """The prolongators and restrictions of every coarse level."""

    p: list
    r: list


def hierarchy(a: sparse.Mat, max_levels: int, smooth: bool,
              min_coarse: int = 64) -> Hierarchy:
    """The (smoothed-)aggregation transfer operators ``build_hierarchy``
    makes from the operator ``a``, level by level. The fine level's
    aggregates are the program's exactly; a coarser level aggregates this
    reference's float64 operator, where a strength test that ties in
    float32 may fall the other way, so a cell that compares more than one
    coarse level has to show that its aggregates agree."""
    ps, rs = [], []
    cur = a
    while len(ps) + 1 < max_levels and cur.shape[0] > min_coarse:
        agg, count = aggregate(cur.rowptr.cpu().numpy(),
                               cur.colidx.cpu().numpy(),
                               cur.vals.cpu().numpy())
        if count >= cur.shape[0]:  # no coarsening progress
            break
        p = prolongator(cur, agg, count, smooth)
        r = sparse.transpose(p)
        ps.append(p)
        rs.append(r)
        cur = galerkin(r, cur, p)[0]
    return Hierarchy(ps, rs)


def galerkin(r: sparse.Mat, a: sparse.Mat, p: sparse.Mat,
             precision: str = "float64") -> tuple[sparse.Mat, int, int]:
    """(R·(A·P), nnzCt of A·P, nnzCt of R·(AP))."""
    ap, n1 = sparse.spgemm(a, p, precision)
    rap, n2 = sparse.spgemm(r, ap, precision)
    return rap, n1, n2


def coarse_operators(h: Hierarchy, a: sparse.Mat, precision: str = "float64"
                     ) -> tuple[list, list]:
    """(every coarse level's operator for the fine operator ``a``, the
    (nnzCt of A·P, nnzCt of R·AP) of every level)."""
    out, counts = [], []
    cur = a
    for p, r in zip(h.p, h.r):
        cur, n1, n2 = galerkin(r, cur, p, precision)
        out.append(cur)
        counts.append((n1, n2))
    return out, counts
