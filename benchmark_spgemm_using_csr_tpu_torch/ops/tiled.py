"""Tiled single-pass SpGEMM for uniform-short-row matrices (stencil / FEM
rows whose intermediate-product count fits one narrow power-of-two width).

Each C row's products are gathered into one row of an (m, W) lane tile
(scatter+cumsum entry map, the chunked expansion machinery), then kernel
K2 (``ops/kernels.bin_sort_compress``) sorts, merges and positions every
row at once, and the run tails are scattered straight into C. No global
product sort: per-row W-lane networks replace it, which pays when W is
small and the tile is well filled.

Reached by name only (``spgemm(..., method="tiled")``), as in the
reference package (``ops/tiled.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from .stream import F32, ones, pad_gentle, scatter
from .symbolic import nnz_upper_bound


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    width: int  # lane width (pow2) >= max nnzCt
    prod_cap: int  # padded total products (entry-map domain)
    out_cap: int  # padded nnzC bound


def make_tiled_plan(a: CSR, b: CSR, max_width: int = 512) -> TiledPlan | None:
    """Returns a plan, or None when this matrix doesn't fit the regime:
    no products, the longest row over ``max_width`` products, or a tile
    fill under 30%."""
    nnz_ct = nnz_upper_bound(a, b).cpu().numpy().astype(np.int64)
    mx = int(nnz_ct.max(initial=0))
    if mx == 0:
        return None
    width = pad_bucket(mx)
    if width > max_width:
        return None
    total = int(nnz_ct.sum())
    if total / (a.m * width) < 0.3:
        return None
    return TiledPlan(
        width=width,
        prod_cap=pad_gentle(total),
        out_cap=pad_gentle(int(nnz_ct.clip(max=b.n).sum())),
    )


def expand_rows(a: CSR, b: CSR, plan: TiledPlan):
    """The (m, W) tile that K2 sorts: row i holds C row i's products, int32
    columns (``b.n`` on dead lanes) and float32 values (0 on dead lanes)."""
    m, n = a.m, b.n
    W = plan.width
    dev = a.device

    # ---- stage 1 + entry map (scatter+cumsum; see ops/chunked.py) ---------
    acol = a.colidx.long()
    a_rows = a.row_ids().long()
    per_nz = torch.where(a_rows < m, b.row_lengths().long()[acol], 0)
    ends = torch.cumsum(per_nz, 0)
    starts = ends - per_nz
    hits = scatter(plan.prod_cap, starts, ones(starts), accumulate=True)
    src = torch.clamp(torch.cumsum(hits, 0) - 1, 0, a.capacity - 1)

    nnz_ct = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    nnz_ct.index_add_(0, a_rows, per_nz)
    nnz_ct = nnz_ct[:m]
    prodstart = torch.cumsum(nnz_ct, 0) - nnz_ct

    # ---- expansion into the (m, W) lane tile ------------------------------
    # the B position of product g is g + (b_start - prod_start) of its
    # entry; int64, where the reference's int32 delta relies on wraparound
    lane = torch.arange(W, dtype=torch.int64, device=dev)
    valid = lane[None, :] < nnz_ct[:, None]
    g = torch.clamp(prodstart[:, None] + lane[None, :], 0, plan.prod_cap - 1)
    e = src[g]  # (m, W) A-entry ids
    delta = b.rowptr.long()[acol] - starts
    bpos = torch.clamp(g + delta[e], 0, b.capacity - 1)
    col = torch.where(valid, b.colidx[bpos], n).to(torch.int32)
    val = torch.where(valid, b.vals.to(F32)[bpos] * a.vals.to(F32)[e], 0.0)
    return col.contiguous(), val.contiguous()


def spgemm_tiled(a: CSR, b: CSR, plan: TiledPlan) -> CSR:
    """C = A @ B via per-row lane tiles and kernel K2; on the card one
    CUDA graph per plan, K2 inside it, from the second call
    (``ops/graphs``)."""
    from . import graphs

    return graphs.run(_spgemm_tiled, plan, a, b)


def _spgemm_tiled(a: CSR, b: CSR, plan: TiledPlan) -> CSR:
    """The eager body of ``spgemm_tiled``."""
    from .kernels import bin_sort_compress

    m, n = a.m, b.n
    col, val = expand_rows(a, b, plan)
    cols_t, vals_t, pos, counts = bin_sort_compress(col, val, n_sentinel=n)

    # ---- stage 4: rowptr + pos-scatter compaction -------------------------
    rowptr = torch.cat([counts.new_zeros(1, dtype=torch.int64),
                        torch.cumsum(counts.long(), 0)])
    tgt = torch.where(pos < plan.width, rowptr[:m, None] + pos,
                      plan.out_cap).reshape(-1)
    colidx = scatter(plan.out_cap, tgt, cols_t.reshape(-1),
                     accumulate=False).to(INDEX_DTYPE)
    vals = scatter(plan.out_cap, tgt, vals_t.reshape(-1).to(a.vals.dtype),
                   accumulate=False)
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=colidx, vals=vals,
               shape=(m, n))
