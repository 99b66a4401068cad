"""Exact sparse triangular solve (SpTRSV), level-scheduled.

- Host symbolic phase: each row's dependency *level* (the longest chain in
  the triangular-solve DAG; ``native/levels``, C++ with a numpy fallback).
  Rows of one level are independent.
- Device numeric phase: a loop of ``n_steps`` eager steps over a row
  *stream*: rows sorted by level, each level padded to a multiple of the
  chunk width so no step mixes levels. A step solves ``chunk`` rows at
  once: masked gathers of the rows' columns and values, a dot with the
  solved x, a divide by the diagonal, a scatter (padding rows land in a
  dropped slot). The schedule serves every value update on the same
  structure (the ILU0 use case).

Entries outside the requested triangle are ignored, so the combined LU
storage of an ILU0 factor solves directly (L = unit diagonal + strictly
lower part, U = upper part with the diagonal).

What differs from the reference package's ``ops/sptrsv.py``: its
``lax.scan`` becomes the Python loop, which the card runs as one CUDA
graph per plan from the second solve on (``ops/graphs``), and its packed
bitcast (colidx, vals) table, a TPU gather-descriptor device, becomes two
direct gathers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..native.levels import csr_levels
from ..sparse.csr import CSR, host_view, pad_bucket


@dataclasses.dataclass(frozen=True)
class TrsvPlan:
    """Static shape/config info for one triangular structure."""

    m: int
    chunk: int
    n_steps: int
    maxlen: int
    lower: bool
    unit_diag: bool
    n_levels: int


@dataclasses.dataclass
class TrsvSchedule:
    """Plan + device tensors (row stream, diagonal positions)."""

    plan: TrsvPlan
    stream: torch.Tensor  # (n_steps * chunk,) int32 row ids, m = padding
    diag_pos: torch.Tensor  # (m,) int32 positions into vals (0 if unit)


def make_trsv_plan(
    a: CSR, lower: bool = True, unit_diag: bool = False,
    chunk: int | None = None,
) -> TrsvSchedule:
    """Host symbolic phase: levels -> padded level-ordered row stream."""
    m, n = a.shape
    if m != n:
        raise ValueError(f"triangular solve needs a square matrix, got {a.shape}")
    rowptr = host_view(a.rowptr)[: m + 1]
    nnz = int(rowptr[-1])
    colidx = host_view(a.colidx)[:nnz]

    levels = csr_levels(rowptr, colidx, m, upper=not lower)
    n_levels = int(levels.max()) + 1 if m else 1

    if chunk is None:
        chunk = int(np.clip(pad_bucket(max(-(-m // max(n_levels, 1)), 1)),
                            8, 1024))
    counts = np.bincount(levels, minlength=n_levels)
    padded = -(-counts // chunk) * chunk
    offsets = np.concatenate([[0], np.cumsum(padded)])
    stream = np.full(int(offsets[-1]), m, np.int32)
    order = np.argsort(levels, kind="stable")  # rows by level, then row
    pos = offsets[levels[order]] + (
        np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[levels[order]]
    )
    stream[pos] = order

    row_of = np.repeat(np.arange(m), np.diff(rowptr))
    diag_pos = np.zeros(m, np.int32)
    if not unit_diag:
        hit = np.flatnonzero(colidx == row_of)
        covered = np.zeros(m, bool)
        covered[row_of[hit]] = True
        if not covered.all():
            missing = int(np.flatnonzero(~covered)[0])
            raise ValueError(
                f"matrix is singular for SpTRSV: row {missing} has no "
                "stored diagonal entry (pass unit_diag=True for unit L)"
            )
        diag_pos[row_of[hit]] = hit
        dvals = host_view(a.vals)[:nnz][diag_pos]
        if not np.all(dvals != 0):
            bad = int(np.flatnonzero(dvals == 0)[0])
            raise ValueError(f"zero diagonal at row {bad}: matrix is singular")

    maxlen = pad_bucket(int(np.diff(rowptr).max()) if m else 1)
    plan = TrsvPlan(
        m=m, chunk=chunk, n_steps=stream.size // chunk, maxlen=maxlen,
        lower=lower, unit_diag=unit_diag, n_levels=n_levels,
    )
    return TrsvSchedule(
        plan=plan,
        stream=torch.from_numpy(stream).to(a.device),
        diag_pos=torch.from_numpy(diag_pos).to(a.device),
    )


def _solve(a: CSR, b: torch.Tensor, stream, diag_pos, plan: TrsvPlan):
    m = plan.m
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = torch.float32
    bvec = b.to(dt)
    vals = a.vals.to(dt)
    if plan.unit_diag:
        dinv = torch.ones(m, dtype=dt, device=a.device)
    else:
        dinv = 1.0 / vals[diag_pos.long()]
    rp = a.rowptr.long()
    colidx = a.colidx.long()
    lane = torch.arange(plan.maxlen, device=a.device)
    multi_rhs = bvec.ndim == 2
    # x has a dump row m for the padding rows of the stream
    x = torch.zeros((m + 1, *bvec.shape[1:]), dtype=dt, device=a.device)
    for rows in stream.long().view(plan.n_steps, plan.chunk):
        r = torch.where(rows < m, rows, 0)
        start = rp[r]
        pos = torch.clamp(start[:, None] + lane[None, :], max=a.capacity - 1)
        emask = lane[None, :] < (rp[r + 1] - start)[:, None]
        cols = colidx[pos]
        intri = cols < r[:, None] if plan.lower else cols > r[:, None]
        keep = emask & intri
        if multi_rhs:
            s = torch.where(keep[..., None], vals[pos][..., None] * x[cols],
                            0).sum(dim=1)
            xi = (bvec[r] - s) * dinv[r][:, None]
        else:
            s = torch.where(keep, vals[pos] * x[cols], 0).sum(dim=1)
            xi = (bvec[r] - s) * dinv[r]
        x[rows] = xi
    return x[:m]


def sptrsv_planned(a: CSR, b, sched: TrsvSchedule):
    """Solve T x = b with a prebuilt schedule (values may differ from the
    plan-time matrix as long as the structure and the diagonal positions
    are the same, e.g. successive ILU0 factors)."""
    from . import graphs

    return graphs.run(_solve, sched.plan, a, b, sched.stream, sched.diag_pos)


def sptrsv(a: CSR, b, lower: bool = True, unit_diag: bool = False):
    """Exact triangular solve T x = b, where T is the lower (upper)
    triangle of ``a`` including the diagonal (or a unit diagonal)."""
    return sptrsv_planned(a, b, make_trsv_plan(a, lower, unit_diag))


def ilu0_apply_exact(f: CSR, r, sched_l: TrsvSchedule | None = None,
                     sched_u: TrsvSchedule | None = None):
    """z = U^{-1} L^{-1} r on combined ILU0 storage ``f`` through two exact
    level-scheduled solves."""
    sched_l = sched_l or make_trsv_plan(f, lower=True, unit_diag=True)
    sched_u = sched_u or make_trsv_plan(f, lower=False)
    return sptrsv_planned(f, sptrsv_planned(f, r, sched_l), sched_u)
