"""Aggregation-structured Galerkin triple product R·A·P, after the
reference package's ``ops/aggrap.py``.

When P is a piecewise-constant aggregation prolongator (exactly one
nonzero per row, what ``models/amg.aggregation_prolongator`` builds) and
R has exactly one nonzero per column, the Galerkin product

    C[I, J] = sum_{i,j} R[I, i] * A[i, j] * P[j, J]

is a relabel-and-merge of A's entries: every A entry (i, j, v) adds
``rv[i] * v * pv[j]`` to C[aggR(i), aggP(j)]. Everything positional is
known at plan time:

- the destination keys ``(I << cbits) | J`` and the scales ``rv[i] *
  pv[j]`` are plan constants in A's CSR entry order;
- a call scales A's values, sorts the int64 keys with ``torch.sort``
  carrying the values, and sums and compacts the runs of equal keys
  (``ops/stream.runsum_compact_scan``);
- C's rowptr and structure are plan constants: only values are computed,
  as in ops/reuse;
- on the card a call replays one CUDA graph per plan from the second call
  on (``ops/graphs``).

Gates (``make_aggrap_plan`` returns None), the reference's exactly:
non-aggregation R/P, values other than float32, key bits > 32, nnz(A) of
0 or above 2**23. So a numeric refresh takes the same route as the
reference on every input.

One deliberate difference: the padding sentinel is ``1 << (ibits +
cbits)``, above every valid key. The reference pads with the uint32
all-ones key, which its 32-bit gate admits as a real key: when m_c and n_c
are both powers of two, entry (m_c - 1, n_c - 1), the last diagonal, gets
that key and is dropped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, host_view
from .stream import pad_gentle, runsum_compact_scan


@dataclasses.dataclass(frozen=True)
class AggRapPlan:
    """Statics for one (R, A-structure, P) triple."""

    w: int  # padded entry-stream slots
    nnz_a: int  # live entries (one contiguous copy)
    out_cap: int  # padded nnz(C)
    nnz_c: int  # exact nnz(C)
    cbits: int  # coarse-column bits in the packed key
    max_run: int  # pow2 bound on any C entry's contributor count
    m_c: int  # coarse rows
    n_c: int  # coarse cols
    sentinel: int  # padding key, 1 << (ibits + cbits)


@dataclasses.dataclass
class AggRapSchedule:
    plan: AggRapPlan
    keys: torch.Tensor  # (w,) int64 constant keys (sentinel padding)
    scale: torch.Tensor  # (w,) float32 constant rv[i]*pv[j] (0 at padding)
    rowptr: torch.Tensor  # (m_c + 1,) int32 constant coarse rowptr


def _aggregation_maps(mat_sp, axis: str):
    """(agg, val) when the matrix is an aggregation operator along
    ``axis`` ('row': one nnz per row, maps row->col; 'col': one nnz per
    column, maps col->row), else None."""
    import scipy.sparse as sp

    if axis == "col":
        m = sp.csr_matrix(mat_sp.T)
    else:
        m = sp.csr_matrix(mat_sp)
    if m.nnz != m.shape[0] or np.any(np.diff(m.indptr) != 1):
        return None
    return m.indices.astype(np.int64), m.data


def make_aggrap_plan(r: CSR, a: CSR, p: CSR) -> AggRapSchedule | None:
    """Host plan: detect aggregation structure, relabel A's entries to
    coarse (I, J) keys, and precompute C's structure exactly."""
    if a.vals.dtype != torch.float32:
        return None
    p_maps = _aggregation_maps(p.to_scipy(), "row")
    r_maps = _aggregation_maps(r.to_scipy(), "col")
    if p_maps is None or r_maps is None:
        return None
    agg_p, pv = p_maps
    agg_r, rv = r_maps
    m_c, n_c = r.m, p.n
    nf_r, nf_c = a.shape
    if agg_r.shape[0] != nf_r or agg_p.shape[0] != nf_c:
        return None
    cbits = max(int(n_c - 1).bit_length(), 1)
    ibits = max(int(m_c - 1).bit_length(), 1)
    if ibits + cbits > 32:
        return None

    rowptr_a = host_view(a.rowptr)[: nf_r + 1].astype(np.int64)
    nnz_a = int(rowptr_a[-1])
    if nnz_a == 0 or nnz_a > (1 << 23):  # the reference's scan-tail guard
        return None
    colidx_a = host_view(a.colidx)[:nnz_a].astype(np.int64)
    rows_a = np.repeat(np.arange(nf_r), np.diff(rowptr_a))
    key_i = agg_r[rows_a]
    key_j = agg_p[colidx_a]
    scale = (rv[rows_a] * pv[colidx_a]).astype(np.float32)

    sentinel = 1 << (ibits + cbits)
    w = pad_gentle(nnz_a, minimum=8)
    keys = np.full(w, sentinel, np.int64)
    keys[:nnz_a] = (key_i << cbits) | key_j
    scale_p = np.zeros(w, np.float32)
    scale_p[:nnz_a] = scale

    # ---- exact C structure (plan constants): one sort and a neighbour
    # compare, not np.unique (sparse/csr.sorted_unique) ---------------------
    s = np.sort(keys[:nnz_a])
    head = np.ones(nnz_a, bool)
    np.not_equal(s[1:], s[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    uniq = s[starts]
    counts = np.diff(np.append(starts, nnz_a))
    nnz_c = int(uniq.shape[0])
    max_run = 1 << max(int(counts.max() - 1).bit_length(), 0)
    rows_c = uniq >> cbits
    rowptr_c = np.zeros(m_c + 1, np.int64)
    np.add.at(rowptr_c, rows_c + 1, 1)
    rowptr_c = np.cumsum(rowptr_c)

    plan = AggRapPlan(
        w=int(w),
        nnz_a=nnz_a,
        out_cap=min(pad_gentle(max(nnz_c, 1)), int(w)),
        nnz_c=nnz_c,
        cbits=cbits,
        max_run=int(max_run),
        m_c=m_c,
        n_c=n_c,
        sentinel=sentinel,
    )
    dev = a.device
    return AggRapSchedule(
        plan=plan,
        keys=torch.from_numpy(keys).to(dev),
        scale=torch.from_numpy(scale_p).to(dev),
        rowptr=torch.from_numpy(rowptr_c.astype(np.int32)).to(dev),
    )


def rap_aggregation(a: CSR, sched: AggRapSchedule) -> CSR:
    """C = R·A·P for NEW VALUES of A on the planned structure (the
    numeric-refresh contract: structure is a plan constant). On the card
    one CUDA graph per plan from the second call (``ops/graphs``)."""
    from . import graphs

    plan = sched.plan
    out_col, out_val = graphs.run(_rap_aggregation, plan, a.vals, sched.keys,
                                  sched.scale)
    return CSR(rowptr=sched.rowptr, colidx=out_col, vals=out_val,
               shape=(plan.m_c, plan.n_c))


def _rap_aggregation(vals, keys, scale, plan: AggRapPlan):
    """The eager body of ``rap_aggregation``: C's (out_cap,) columns and
    values. The constant keys are sorted on every call, as in the
    reference's jit body."""
    buf = torch.zeros(plan.w, dtype=vals.dtype, device=vals.device)
    buf[: plan.nnz_a] = vals[: plan.nnz_a]
    okey, perm = torch.sort(keys)
    oval = (buf * scale)[perm]
    keyc, valc, _ = runsum_compact_scan(
        okey, oval, w=plan.w, out_cap=plan.out_cap, max_run=plan.max_run,
        sentinel=plan.sentinel,
    )
    live = torch.arange(plan.out_cap, device=vals.device) < plan.nnz_c
    out_col = torch.where(live, keyc & ((1 << plan.cbits) - 1), 0)
    return out_col.to(INDEX_DTYPE), torch.where(live, valc, 0)
