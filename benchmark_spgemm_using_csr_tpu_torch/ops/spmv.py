"""SpMV / SpMM on the CSR and BSR containers.

- CSR: gather, multiply, and an index-add into the rows. Memory-bound;
  right for very sparse rows.
- BSR x dense: each stored (bm, bn) block times its slice of X in one
  ``torch.bmm``, then an index-add over block rows.

Only the stored entries (or blocks) take part: the reference package sums
the padding too (into a dropped row m, or column 0 for ``spmv_t``), which
on the card would send every padding slot's atomic add to one address.
The count comes from the host mirror of rowptr (``host_view``), which a
CSR built from host arrays already holds.
"""
from __future__ import annotations

import torch

from ..sparse.csr import BSR, CSR, host_view, row_ids_from_rowptr
from .dense import ieee_fp32


def _stored(rowptr) -> int:
    return int(host_view(rowptr)[-1])


def _row_sum(prod: torch.Tensor, rows: torch.Tensor, m: int) -> torch.Tensor:
    """Per-row sums of ``prod``, whose entry i belongs to row rows[i]."""
    out = torch.zeros((m, *prod.shape[1:]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, rows.long(), prod)


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for dense x of shape (n,)."""
    nnz = _stored(a.rowptr)
    prod = a.vals[:nnz] * x[a.colidx[:nnz].long()]
    return _row_sum(prod, row_ids_from_rowptr(a.rowptr, nnz), a.m)


def spmm(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (n, k)."""
    nnz = _stored(a.rowptr)
    prod = a.vals[:nnz, None] * x[a.colidx[:nnz].long()]
    return _row_sum(prod, row_ids_from_rowptr(a.rowptr, nnz), a.m)


def bsr_spmm(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in BSR: a batched product over the stored blocks,
    then a sum over block rows."""
    bm, bn = a.block_shape
    mb = a.shape[0] // bm
    k = x.shape[1]
    nnzb = _stored(a.rowptr)
    gathered = x.reshape(a.shape[1] // bn, bn, k)[a.colidx[:nnzb].long()]
    with ieee_fp32():
        partial = torch.bmm(a.blocks[:nnzb], gathered.to(a.blocks.dtype))
    brow = row_ids_from_rowptr(a.rowptr, nnzb)
    return _row_sum(partial, brow, mb).reshape(mb * bm, k)


def spmv_t(a: CSR, y: torch.Tensor, transpose_out_n: int) -> torch.Tensor:
    """x = A^T @ y without materializing the transpose (scatter-add)."""
    nnz = _stored(a.rowptr)
    rows = row_ids_from_rowptr(a.rowptr, nnz).long()
    contrib = a.vals[:nnz] * y[rows]
    return _row_sum(contrib, a.colidx[:nnz], transpose_out_n)
