"""Structure-reuse numeric SpGEMM: recompute C = A @ B values when the
sparsity structures of A, B (and therefore C) are fixed, and the fused
Galerkin triple product R @ A @ P on a fixed structure.

The host plans are the reference package's (``ops/reuse.py``), copied:
they enumerate the whole product stream (every (A[i,k], B[k,j]) pair, or
every (R[q,i], A[i,k], P[k,j]) triple) sorted by destination slot in C,
and C's structure from a scipy pattern product.

The device pass is sort-free and scatter-free: value gathers in
destination order, one multiply, then one sum per C slot. The reference
sums with a segmented ``lax.associative_scan``; here the sum is
``torch.segment_reduce`` over the per-slot product counts. Either keeps
the rounding error inside each slot's own products; a global
cumsum-then-diff does not, and on a mixed-sign stream with large
cancellation it falls outside the float32 tolerance
(``tests/test_torch_reuse.py`` shows it), and its order is fixed, so a
CUDA graph's replay (``ops/graphs``) is bit-equal to the eager call.
bfloat16 products accumulate in float32, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, host_view, pad_bucket
from .stream import pad_gentle


@dataclasses.dataclass(frozen=True)
class NumericPlan:
    """Statics for one (A-structure, B-structure) pair."""

    m: int
    n: int
    total: int  # exact intermediate-product count
    nnz_c: int  # exact nnz(C)
    prod_cap: int  # padded product-stream length
    out_cap: int  # padded C capacity


@dataclasses.dataclass
class NumericSchedule:
    """Plan + device tensors: the precomputed product -> C mapping."""

    plan: NumericPlan
    a_idx: torch.Tensor  # (prod_cap,) int64 into a.vals, dest-sorted
    b_idx: torch.Tensor  # (prod_cap,) int64 into b.vals, dest-sorted
    lengths: torch.Tensor  # (nnz_c,) int64 products per C slot
    rowptr: torch.Tensor  # (m+1,) C row pointers
    colidx: torch.Tensor  # (out_cap,) C column indices, pad=0


def _pattern(rowptr, colidx, shape):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.ones(colidx.shape[0], np.float64), colidx.astype(np.int32),
         rowptr),
        shape=shape,
    )


def _structure(a: CSR, rows: int):
    """(rowptr, colidx) of ``a`` as exact int64 host arrays."""
    rowptr = host_view(a.rowptr)[: rows + 1].astype(np.int64)
    return rowptr, host_view(a.colidx)[: int(rowptr[-1])].astype(np.int64)


def _dest_order(pc, m: int, n: int, i_prod, j_prod):
    """(order, lengths): the stable destination sort of the products and
    the product count of every C slot."""
    c_row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(pc.indptr))
    c_key = c_row_of * n + pc.indices.astype(np.int64)
    dest = np.searchsorted(c_key, i_prod * n + j_prod)
    order = np.argsort(dest, kind="stable")
    return order, np.bincount(dest, minlength=int(pc.nnz))


def make_numeric_plan(a: CSR, b: CSR) -> NumericSchedule:
    """Host symbolic phase: C pattern + dest-ordered product mapping.

    One-time O(total_products log) numpy work; the returned schedule is
    valid for any values placed in the same A/B sparsity structures.
    """
    m, k_dim = a.shape
    k2, n = b.shape
    if k_dim != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    a_rowptr, a_colidx = _structure(a, m)
    b_rowptr, b_colidx = _structure(b, k2)
    nnz_a = a_colidx.shape[0]

    a_row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_rowptr))
    lens = b_rowptr[a_colidx + 1] - b_rowptr[a_colidx]  # products per A entry
    total = int(lens.sum())

    # product stream in natural (A-entry-major) order
    a_idx_nat = np.repeat(np.arange(nnz_a, dtype=np.int64), lens)
    starts = np.cumsum(lens) - lens
    b_idx_nat = (
        np.arange(total, dtype=np.int64)
        - np.repeat(starts, lens)
        + np.repeat(b_rowptr[a_colidx], lens)
    )
    i_prod = np.repeat(a_row_of, lens)
    j_prod = b_colidx[b_idx_nat]

    # C pattern from the structural product (scipy; canonical sorted cols)
    pc = (_pattern(a_rowptr, a_colidx, (m, k_dim))
          @ _pattern(b_rowptr, b_colidx, (k2, n))).tocsr()
    pc.sort_indices()
    nnz_c = int(pc.nnz)
    order, lengths = _dest_order(pc, m, n, i_prod, j_prod)

    prod_cap = pad_gentle(max(total, 8))
    out_cap = pad_bucket(max(nnz_c, 8))
    a_idx = np.zeros(prod_cap, np.int64)
    b_idx = np.zeros(prod_cap, np.int64)
    a_idx[:total] = a_idx_nat[order]
    b_idx[:total] = b_idx_nat[order]
    colidx = np.zeros(out_cap, np.int32)
    colidx[:nnz_c] = pc.indices

    dev = a.device
    plan = NumericPlan(
        m=m, n=n, total=total, nnz_c=nnz_c, prod_cap=prod_cap, out_cap=out_cap
    )
    return NumericSchedule(
        plan=plan,
        a_idx=torch.from_numpy(a_idx).to(dev),
        b_idx=torch.from_numpy(b_idx).to(dev),
        lengths=torch.from_numpy(lengths.astype(np.int64)).to(dev),
        rowptr=torch.from_numpy(pc.indptr.astype(np.int32)).to(dev),
        colidx=torch.from_numpy(colidx).to(dev),
    )


def _slot_sums(prod: torch.Tensor, lengths: torch.Tensor, out_cap: int,
               dt: torch.dtype) -> torch.Tensor:
    """(out_cap,) values: the sum of each C slot's products (a reduction
    per segment, never a global cumsum), 0 past nnz(C)."""
    acc = torch.float32 if dt == torch.bfloat16 else dt
    out = torch.zeros(out_cap, dtype=dt, device=prod.device)
    nnz_c = lengths.shape[0]
    if nnz_c:
        out[:nnz_c] = torch.segment_reduce(
            prod.to(acc), "sum", lengths=lengths, unsafe=True).to(dt)
    return out


def spgemm_numeric(a: CSR, b: CSR, sched: NumericSchedule) -> CSR:
    """Numeric-only C = A @ B on a prebuilt structure plan.

    ``a``/``b`` may carry different values than at plan time but MUST have
    the exact sparsity structures the plan was built from (not checked on
    the hot path). Output structure is identical across calls. On the card
    one CUDA graph per plan from the second call (``ops/graphs``).
    """
    from . import graphs

    plan = sched.plan
    vals = graphs.run(_numeric, plan, a.vals, b.vals, sched.a_idx,
                      sched.b_idx, sched.lengths)
    return CSR(sched.rowptr, sched.colidx, vals, (plan.m, plan.n))


def _numeric(a_vals, b_vals, a_idx, b_idx, lengths, plan: NumericPlan):
    """The eager body of ``spgemm_numeric``: C's (out_cap,) values."""
    dt = torch.promote_types(a_vals.dtype, b_vals.dtype)
    prod = (a_vals.to(dt)[a_idx[: plan.total]]
            * b_vals.to(dt)[b_idx[: plan.total]])
    return _slot_sums(prod, lengths, plan.out_cap, dt)


# ---------------------------------------------------------------------------
# Fused Galerkin triple product  RAP = R @ A @ P  on a fixed structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriplePlan:
    """Statics for one (R, A, P) structure triple."""

    m: int  # rows of RAP (= rows of R)
    n: int  # cols of RAP (= cols of P)
    total: int  # exact triple-product count
    nnz_c: int  # exact nnz(RAP)
    prod_cap: int
    out_cap: int
    nnz_r: int  # value-vector offsets for the concatenated gather table
    nnz_a: int


@dataclasses.dataclass
class TripleSchedule:
    plan: TriplePlan
    idx3: torch.Tensor  # (prod_cap, 3) int64 into cat(r.vals, a.vals, p.vals)
    lengths: torch.Tensor  # (nnz_c,) int64 triples per RAP slot
    rowptr: torch.Tensor  # (m+1,)
    colidx: torch.Tensor  # (out_cap,)


def make_triple_plan(
    r: CSR, a: CSR, p: CSR, max_products: int = 1 << 26
) -> TripleSchedule | None:
    """Host symbolic phase for the fused Galerkin product RAP = R @ A @ P.

    Enumerates every triple (R[q,i], A[i,k], P[k,j]) sorted by destination
    slot of RAP, so the device pass is one 3-wide value gather, one
    multiply and one sum per slot: no sort, no scatter, no intermediate
    AP. For aggregation-style P/R (one nnz per row/column, models/amg.py)
    the triple stream is exactly nnz(A) products.

    Returns None when the triple stream is empty or exceeds
    ``max_products`` (dense P/R blow the cartesian expansion: chain two
    products instead).
    """
    import scipy.sparse as sp

    mq, mi = r.shape
    mi2, mk = a.shape
    mk2, n = p.shape
    if mi != mi2 or mk != mk2:
        raise ValueError(f"chain mismatch: {r.shape} @ {a.shape} @ {p.shape}")

    a_rowptr, a_colidx = _structure(a, mi)
    nnz_a = a_colidx.shape[0]
    p_rowptr, p_colidx = _structure(p, mk)
    r_rowptr, r_colidx = _structure(r, mq)
    nnz_r = r_colidx.shape[0]

    # R by COLUMN i (CSC-style) with data = value indices into r.vals
    r_rows = np.repeat(np.arange(mq, dtype=np.int64), np.diff(r_rowptr))
    rT = sp.csr_matrix(
        (np.arange(nnz_r, dtype=np.int64), (r_colidx, r_rows)), shape=(mi, mq)
    )
    rT.sort_indices()
    rt_rowptr = rT.indptr.astype(np.int64)
    rt_q = rT.indices.astype(np.int64)  # RAP row per rT entry
    rt_vidx = rT.data.astype(np.int64)  # r.vals index per rT entry

    a_rows = np.repeat(np.arange(mi, dtype=np.int64), np.diff(a_rowptr))
    deg_r = rt_rowptr[a_rows + 1] - rt_rowptr[a_rows]  # per A entry
    deg_p = p_rowptr[a_colidx + 1] - p_rowptr[a_colidx]
    cnt = deg_r * deg_p
    total = int(cnt.sum())
    if total == 0 or total > max_products:
        return None

    e = np.repeat(np.arange(nnz_a, dtype=np.int64), cnt)  # A-entry id
    starts_e = np.cumsum(cnt) - cnt
    t = np.arange(total, dtype=np.int64) - starts_e[e]
    dpe = deg_p[e]
    ri = rt_rowptr[a_rows[e]] + t // dpe
    pi = p_rowptr[a_colidx[e]] + t % dpe

    # RAP pattern (scipy; canonical) and destination mapping
    pc = (_pattern(r_rowptr, r_colidx, (mq, mi))
          @ (_pattern(a_rowptr, a_colidx, (mi, mk))
             @ _pattern(p_rowptr, p_colidx, (mk, n)))).tocsr()
    pc.sort_indices()
    nnz_c = int(pc.nnz)
    order, lengths = _dest_order(pc, mq, n, rt_q[ri], p_colidx[pi])

    prod_cap = pad_gentle(max(total, 8))
    out_cap = pad_bucket(max(nnz_c, 8))
    # one 3-wide gather table into cat(r.vals, a.vals, p.vals)
    idx3 = np.zeros((prod_cap, 3), np.int64)
    idx3[:total, 0] = rt_vidx[ri][order]
    idx3[:total, 1] = nnz_r + e[order]
    idx3[:total, 2] = nnz_r + nnz_a + pi[order]
    colidx = np.zeros(out_cap, np.int32)
    colidx[:nnz_c] = pc.indices

    dev = a.device
    plan = TriplePlan(
        m=mq, n=n, total=total, nnz_c=nnz_c, prod_cap=prod_cap,
        out_cap=out_cap, nnz_r=nnz_r, nnz_a=nnz_a,
    )
    return TripleSchedule(
        plan=plan,
        idx3=torch.from_numpy(idx3).to(dev),
        lengths=torch.from_numpy(lengths.astype(np.int64)).to(dev),
        rowptr=torch.from_numpy(pc.indptr.astype(np.int32)).to(dev),
        colidx=torch.from_numpy(colidx).to(dev),
    )


def spgemm_triple(r: CSR, a: CSR, p: CSR, sched: TripleSchedule) -> CSR:
    """Numeric-only RAP = R @ A @ P on a prebuilt triple plan (no
    intermediate AP); on the card one CUDA graph per plan from the second
    call (``ops/graphs``)."""
    from . import graphs

    plan = sched.plan
    vals = graphs.run(_triple_numeric, plan, r.vals, a.vals, p.vals,
                      sched.idx3, sched.lengths)
    return CSR(sched.rowptr, sched.colidx, vals, (plan.m, plan.n))


def _triple_numeric(r_vals, a_vals, p_vals, idx3, lengths,
                    plan: TriplePlan):
    """The eager body of ``spgemm_triple``: RAP's (out_cap,) values."""
    dt = torch.promote_types(torch.promote_types(r_vals.dtype, a_vals.dtype),
                             p_vals.dtype)
    cat = torch.cat([
        r_vals.to(dt)[: plan.nnz_r],
        a_vals.to(dt)[: plan.nnz_a],
        p_vals.to(dt),
    ])
    v3 = cat[idx3[: plan.total]]  # (total, 3)
    prod = v3[:, 0] * v3[:, 1] * v3[:, 2]
    return _slot_sums(prod, lengths, plan.out_cap, dt)
