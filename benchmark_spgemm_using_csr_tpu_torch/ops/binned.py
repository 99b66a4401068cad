"""Binned numeric path: rows binned by intermediate-product count, one
dense (rows, width) tile per bin, each row sorted and merged along its
lanes.

The reference benchmark bins rows into 38 bins and runs a heap, a bitonic
ESC or a merge method per bin; the reference package keeps the binning and
replaces the three methods by one tile primitive per width
(``ops/binned.py``). Here every bin's tile goes through kernel K2
(``ops/kernels.bin_sort_compress``): the fused sort + merge + positions
of the reference's ``"pallas"`` backend, run as its plain version on CPU
tensors, in the values' own type (float32 or float64). The reference's
default ``"xla"`` backend, a ``lax.sort`` lane sort, has no counterpart:
it gives the same structure, and values that differ only in the order of
the additions.

Rows whose product count exceeds the last width go through the global ESC
sort on just their products (the merge-method analogue); rows with zero
products are never touched. Out-of-range scatters go to a dump slot past
the end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, csr_gather_rows, host_view, pad_bucket
from .esc import spgemm_esc_padded
from .stream import gather_products, scatter
from .symbolic import nnz_upper_bound

DEFAULT_WIDTHS = (8, 32, 128, 512)


def _bin_products(a: CSR, b: CSR, rows, nnz_ct, prodstart, width: int):
    """The (r_pad, width) product tile of one bin: int32 columns (``b.n``
    on dead lanes; rows padded with ``a.m`` are all dead) and values."""
    m, n = a.m, b.n
    rows_c = torch.clamp(rows, max=m - 1)
    in_range = rows < m
    lens = torch.where(in_range, nnz_ct[rows_c], 0)
    start = torch.where(in_range, prodstart[rows_c], 0)
    lane = torch.arange(width, dtype=torch.int64, device=a.device)
    valid = lane[None, :] < lens[:, None]
    g = start[:, None] + lane[None, :]
    _, col, val = gather_products(a, b, torch.where(valid, g, 0), valid)
    col = torch.where(valid, col, n).to(torch.int32)
    return col, val


@dataclasses.dataclass(frozen=True)
class BinPlan:
    """The static of one bin's stage: its lane width, as the reference's
    ``_bin_numeric`` is keyed on ``width``."""

    width: int


def _bin_numeric(a: CSR, b: CSR, rows, nnz_ct, prodstart, plan: BinPlan):
    """One bin's stage: its product tile through K2. Returns (cols, vals,
    pos, counts) as ``kernels.bin_sort_compress`` does."""
    from .kernels import bin_sort_compress

    col, val = _bin_products(a, b, rows, nnz_ct, prodstart, plan.width)
    return bin_sort_compress(col, val.contiguous(), n_sentinel=b.n)


def _counts_add(counts_full, rows, counts):
    """counts_full[rows] += counts; rows padded with m are dropped."""
    return counts_full + scatter(counts_full.shape[0], rows,
                                 counts.to(counts_full.dtype),
                                 accumulate=True)


def _rowptr_from_counts(counts_full):
    return torch.cat([counts_full.new_zeros(1),
                      torch.cumsum(counts_full, 0)]).to(INDEX_DTYPE)


def _scatter_bin(colidx_buf, vals_buf, rowptr, rows, cols_t, vals_t, counts):
    """Stage-4 compaction of one (rows, width) tile: lane l < counts[r] of
    row r lands at rowptr[rows[r]] + l; the other lanes (and rows padded
    with m) are dropped. Returns new (colidx, vals) buffers."""
    out_capacity = colidx_buf.shape[0]
    width = cols_t.shape[1]
    lane = torch.arange(width, device=cols_t.device)
    valid = lane[None, :] < counts.long()[:, None]
    base = rowptr.long()[rows.long()]  # rows padded with m: masked out
    tgt = torch.where(valid, base[:, None] + lane[None, :], out_capacity)
    tgt = tgt.reshape(-1)
    colidx = torch.cat([colidx_buf, colidx_buf.new_zeros(1)])
    vals = torch.cat([vals_buf, vals_buf.new_zeros(1)])
    colidx[tgt] = cols_t.reshape(-1).to(colidx.dtype)
    vals[tgt] = vals_t.reshape(-1).to(vals.dtype)
    return colidx[:out_capacity], vals[:out_capacity]


def make_plan(nnz_ct: np.ndarray, widths=DEFAULT_WIDTHS):
    """Host stage 2: assign rows to width bins. Returns {width: padded row
    index array} (padded with m to a power-of-two bucket) and the long-row
    tail rows."""
    m = nnz_ct.shape[0]
    bins = {}
    prev = 0
    for w in widths:
        mask = (nnz_ct > prev) & (nnz_ct <= w)
        rows = np.nonzero(mask)[0].astype(np.int32)
        if rows.size:
            padded = np.full(pad_bucket(rows.size), m, np.int32)
            padded[: rows.size] = rows
            bins[w] = padded
        prev = w
    tail = np.nonzero(nnz_ct > widths[-1])[0].astype(np.int32)
    return bins, tail


def spgemm_binned_host(
    a: CSR,
    b: CSR,
    prod_capacity: int,
    out_capacity: int | None = None,
    widths=DEFAULT_WIDTHS,
) -> CSR:
    """Full binned SpGEMM (host-orchestrated over per-bin device stages).
    On the card each bin's stage replays one CUDA graph per (width, bin
    shape) from the second call, and so does the tail's ESC
    (``ops/graphs``)."""
    from . import graphs

    dev = a.device
    out_capacity = out_capacity or prod_capacity
    nnz_ct_dev = nnz_upper_bound(a, b).long()
    nnz_ct = nnz_ct_dev.cpu().numpy()
    prodstart = torch.cumsum(nnz_ct_dev, 0) - nnz_ct_dev

    bins, tail = make_plan(nnz_ct, widths)
    pieces = []  # (rows, cols, vals, counts, pos)
    for w, rows in bins.items():
        rows_dev = torch.from_numpy(rows).to(dev).long()
        cols_t, vals_t, pos, counts = graphs.run(
            _bin_numeric, BinPlan(w), a, b, rows_dev, nnz_ct_dev, prodstart)
        pieces.append((rows_dev, cols_t, vals_t, counts, pos))

    c_tail = tail_dev = None
    if tail.size:
        tail_dev = torch.from_numpy(tail).to(dev).long()
        rowptr_h = host_view(a.rowptr).astype(np.int64)
        nnz_a_tail = int((rowptr_h[tail + 1] - rowptr_h[tail]).sum())
        a_tail = csr_gather_rows(a, tail_dev, pad_bucket(nnz_a_tail))
        prod_tail = pad_bucket(int(nnz_ct[tail].sum()))
        c_tail = spgemm_esc_padded(a_tail, b, prod_tail, prod_tail)

    return _assemble(a, b, pieces, c_tail, tail_dev, out_capacity)


def _assemble(a: CSR, b: CSR, pieces, c_tail, tail_rows, out_capacity: int):
    """Stage 4 of the binned paths: exact per-row counts -> rowptr -> every
    bin's K2 output (placed by its ``pos``) and the tail's CSR (its rows
    ``tail_rows``) to their place in C. Rows padded with m are dropped."""
    m, n = a.m, b.n
    dev = a.device
    counts_full = torch.zeros(m, dtype=torch.int64, device=dev)
    for rows_dev, _, _, counts, _ in pieces:
        counts_full = _counts_add(counts_full, rows_dev, counts)
    if c_tail is not None:
        counts_full = _counts_add(counts_full, tail_rows, c_tail.row_lengths())
    rowptr = _rowptr_from_counts(counts_full).long()

    # stage 4: every bin's entries to their place in C
    tgts, cols, vals = [], [], []
    for rows_dev, cols_t, vals_t, counts, pos in pieces:
        width = cols_t.shape[1]
        tgts.append(torch.where(pos < width, rowptr[rows_dev][:, None] + pos,
                                out_capacity).reshape(-1))
        cols.append(cols_t.reshape(-1))
        vals.append(vals_t.reshape(-1).to(a.vals.dtype))
    if c_tail is not None:
        local_row = c_tail.row_ids().long()
        local_row_c = torch.clamp(local_row, max=c_tail.m - 1)
        offset = (torch.arange(c_tail.capacity, device=dev)
                  - c_tail.rowptr.long()[local_row_c])
        orig = tail_rows[local_row_c]
        tgts.append(torch.where(local_row < c_tail.m, rowptr[orig] + offset,
                                out_capacity))
        cols.append(c_tail.colidx)
        vals.append(c_tail.vals.to(a.vals.dtype))
    if tgts:
        tgt = torch.cat(tgts)
        colidx = scatter(out_capacity, tgt, torch.cat(cols).to(INDEX_DTYPE),
                         accumulate=False)
        vals_buf = scatter(out_capacity, tgt, torch.cat(vals),
                           accumulate=False)
    else:
        colidx = torch.zeros(out_capacity, dtype=INDEX_DTYPE, device=dev)
        vals_buf = torch.zeros(out_capacity, dtype=a.vals.dtype, device=dev)
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=colidx, vals=vals_buf,
               shape=(m, n))
