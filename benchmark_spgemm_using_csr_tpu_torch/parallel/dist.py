"""Row-partitioned SpGEMM plans.

For now this holds ``make_dist_local_plan``, the per-block chunked plan that
the out-of-core path (``ops/batched``) runs on each of its row blocks; the
distributed schedules of the reference package's ``parallel/dist.py`` come
to this module later.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.chunked import ChunkedPlan, make_chunked_plan, pad_gentle
from ..sparse.csr import CSR, host_view


def make_dist_local_plan(
    a: CSR, b: CSR, n_shards: int, *, bounds: np.ndarray,
) -> ChunkedPlan:
    """One ChunkedPlan for every row block: the whole matrix's mode
    decisions (k, al-aligned tables, wide split, scatter-SET, all
    per-matrix) with the capacities recomputed as the max over the blocks,
    so one plan serves each.

    bounds: the blocks' row boundaries (n_shards + 1,), from 0 to m (the
    out-of-core path's product-balanced blocks).
    """
    base = make_chunked_plan(a, b)
    if base.al_min:  # mixed mode is never picked by the plan; keep it pure
        base = make_chunked_plan(a, b, al=base.al)

    m = a.m
    rowptr = host_view(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(rowptr[-1])
    row_bounds = np.asarray(bounds, np.int64)
    if len(row_bounds) != n_shards + 1:
        raise ValueError(f"{len(row_bounds)} bounds for {n_shards} blocks")
    bounds_e = rowptr[row_bounds]
    b_len = np.diff(host_view(b.rowptr)).astype(np.int64)
    lens_all = b_len[host_view(a.colidx)[:nnz_a]]

    def seg_sum(x):  # per-block sums of an entry-level array
        cs = np.concatenate([[0], np.cumsum(x, dtype=np.int64)])
        return cs[bounds_e[1:]] - cs[bounds_e[:-1]]

    wide = lens_all >= base.wide_min if base.wide_min else np.zeros(
        lens_all.shape, bool
    )
    lens_s = np.where(wide, 0, lens_all)  # short-row substream lengths
    q = base.al or base.k
    chunks_e = -(-lens_s // q)
    if base.scatter_set:  # every real entry owns >= 1 chunk (dummies)
        chunks_e = np.maximum(chunks_e, 1)
    chunks_max = int(seg_sum(chunks_e).max(initial=1))
    wchunks_max = int(
        seg_sum(-(-np.where(wide, lens_all, 0) // base.wide_lanes)).max(
            initial=1)
    ) if base.wide_min else 0

    # per-block output bound: sum over the block's rows of min(products, n)
    prod_row = np.concatenate([[0], np.cumsum(lens_all, dtype=np.int64)])
    row_prod = prod_row[rowptr[1:]] - prod_row[rowptr[:-1]]
    oc = np.concatenate([[0], np.cumsum(np.minimum(row_prod, b.n),
                                        dtype=np.int64)])
    out_max = int((oc[row_bounds[1:]] - oc[row_bounds[:-1]]).max(initial=1))

    return dataclasses.replace(
        base,
        chunks_cap=pad_gentle(chunks_max),
        wchunks_cap=pad_gentle(wchunks_max) if base.wide_min else 0,
        out_cap=pad_gentle(out_max),
        nchunks_cap=0,
        al_min=0,
    )
