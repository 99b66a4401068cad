"""Hash-path numeric kernel: a dense accumulator per row tile.

A GPU hash method builds a per-row open-addressing table in shared memory.
Here the table is the perfect hash, a dense accumulator row of width n:

    acc[r, col] += val        (one scatter-add over all products)
    occ[r, col]  = True       (structural occupancy)

followed by a per-row compaction of the occupied slots into CSR. The
occupancy mask, not ``acc != 0``, decides the structure, so entries that
cancel numerically stay as explicit zeros.

Memory: a tile of R rows costs R * n * (itemsize + 1) bytes; ``spgemm_hash``
picks R from the reference package's byte budget formula and loops over
tiles on the host. Stage 4 uses the binned path's helpers.

What differs from the reference package's ``ops/hash.py``: its (R, n) row
and column iotas and the drop-mode compaction scatters become one
``nonzero`` of the occupancy mask, which yields the occupied slots in
row-major, column-sorted order; the tiles it returns are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse.csr import (
    CSR,
    INDEX_DTYPE,
    acc_dtype,
    csr_gather_rows,
    host_view,
    pad_bucket,
)
from .binned import _counts_add, _rowptr_from_counts, _scatter_bin
from .stream import gather_products
from .symbolic import nnz_upper_bound, total_products


def _hash_numeric_tile(a_tile: CSR, b: CSR, prod_cap: int, out_width: int):
    """Dense-accumulator kernel for one row tile (a_tile: the tile's rows,
    from csr_gather_rows). Returns (cols, vals, counts): (R, out_width)
    unique columns in ascending order, merged values, exact nnzC per row."""
    r = a_tile.m
    n = b.n
    dev = a_tile.device
    g = torch.arange(prod_cap, device=dev)
    valid = g < total_products(a_tile, b)
    src, col, val = gather_products(a_tile, b, torch.where(valid, g, 0), valid)
    row = torch.clamp(a_tile.row_ids().long()[src], max=r - 1)
    # invalid products go to a dropped sentinel row r
    flat = torch.where(valid, row, r) * n + col
    acc = torch.zeros((r + 1) * n, dtype=acc_dtype(a_tile.vals.dtype),
                      device=dev)
    acc.index_add_(0, flat, val.to(acc.dtype))
    occ = torch.zeros((r + 1) * n, dtype=torch.bool, device=dev)
    occ[flat] = True
    acc, occ = acc.view(r + 1, n)[:r], occ.view(r + 1, n)[:r]

    counts = occ.sum(dim=1)
    rr, cc = occ.nonzero(as_tuple=True)  # row-major: columns sorted per row
    first = torch.cumsum(counts, 0) - counts
    lane = torch.arange(rr.shape[0], device=dev) - first[rr]
    cols = torch.zeros((r, out_width), dtype=INDEX_DTYPE, device=dev)
    vals = torch.zeros((r, out_width), dtype=acc.dtype, device=dev)
    cols[rr, lane] = cc.to(INDEX_DTYPE)
    vals[rr, lane] = acc[rr, cc]
    return cols, vals, counts.to(INDEX_DTYPE)


def hash_tile_rows(a: CSR, b: CSR, rows: np.ndarray, nnz_ct: np.ndarray):
    """The dense-accumulator kernel on a row subset (``rows``: host row
    indices, no sentinels). Returns device (cols, vals, counts) tiles of
    width pad_bucket(min(max nnzCt, n))."""
    rows_pad = np.full(pad_bucket(rows.size), a.m, np.int32)
    rows_pad[: rows.size] = rows
    rowptr = host_view(a.rowptr).astype(np.int64)
    nnz_a_rows = int((rowptr[rows + 1] - rowptr[rows]).sum())
    a_tile = csr_gather_rows(a, torch.from_numpy(rows_pad).to(a.device),
                             pad_bucket(nnz_a_rows))
    # the exact product count: products past it would all add into one
    # dropped slot (the reference pads it to a bucket for its compiler)
    prod_cap = int(nnz_ct[rows].sum())
    out_width = pad_bucket(min(int(nnz_ct[rows].max(initial=1)), b.n))
    return _hash_numeric_tile(a_tile, b, prod_cap, out_width)


def spgemm_hash(
    a: CSR,
    b: CSR,
    tile_bytes_budget: int = 512 * 1024 * 1024,
    out_capacity: int | None = None,
) -> CSR:
    """C = A @ B through dense-accumulator row tiles (host-orchestrated):
    every non-empty row goes through tiles of R rows, R * n *
    (itemsize + 4 + 4) within the byte budget."""
    m, n = a.m, b.n
    dev = a.device
    itemsize = a.vals.element_size()
    r_tile = max(int(tile_bytes_budget // (n * (itemsize + 4 + 4))), 8)
    r_tile = min(pad_bucket(r_tile), pad_bucket(m))

    nnz_ct = nnz_upper_bound(a, b).cpu().numpy()
    nonempty = np.nonzero(nnz_ct > 0)[0].astype(np.int32)

    pieces = []
    for lo in range(0, nonempty.size, r_tile):
        rows = nonempty[lo: lo + r_tile]
        cols_t, vals_t, counts = hash_tile_rows(a, b, rows, nnz_ct)
        rows_pad = np.full(pad_bucket(rows.size), m, np.int32)
        rows_pad[: rows.size] = rows
        pieces.append((torch.from_numpy(rows_pad).to(dev), cols_t, vals_t,
                       counts))

    counts_full = torch.zeros(m, dtype=torch.int64, device=dev)
    for rows_dev, _, _, counts in pieces:
        counts_full = _counts_add(counts_full, rows_dev, counts)
    rowptr = _rowptr_from_counts(counts_full)

    out_capacity = out_capacity or pad_bucket(int(counts_full.sum()))
    colidx_buf = torch.zeros(out_capacity, dtype=INDEX_DTYPE, device=dev)
    vals_buf = torch.zeros(out_capacity, dtype=a.vals.dtype, device=dev)
    for rows_dev, cols_t, vals_t, counts in pieces:
        colidx_buf, vals_buf = _scatter_bin(
            colidx_buf, vals_buf, rowptr, rows_dev, cols_t, vals_t, counts
        )
    return CSR(rowptr=rowptr, colidx=colidx_buf, vals=vals_buf, shape=(m, n))
