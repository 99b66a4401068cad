"""Global ESC (Expand–Sort–Compress) SpGEMM — the baseline numeric path.

Materialize every intermediate product as a (row, col, val) triple in one
padded buffer, sort by (row, col), and compress duplicates — static buffer
sizes, no per-row launches. Correct for every row-size regime; the other
numeric paths are checked against it.

The (row, col) pair sorts as ONE int64 key ``row << 32 | col`` (both are
int32 quantities), where the reference package sorts two int32 keys; the
resulting CSR is the same.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sparse.csr import CSR, INDEX_DTYPE
from .stream import gather_products, products_per_nz


def expand_products(a: CSR, b: CSR, prod_capacity: int):
    """Stage-3a expansion: enumerate all intermediate products.

    Returns int64 (row, col) and (val) of shape (prod_capacity,). Products
    beyond the true total get sentinel row == m (sorts to the tail)."""
    m = a.m
    total = products_per_nz(a, b).sum(dtype=torch.int64)
    p = torch.arange(prod_capacity, dtype=torch.int64, device=a.device)
    valid = p < total
    src_c, col, val = gather_products(a, b, p, valid)
    row = torch.where(valid, a.row_ids().long()[src_c], m)
    return row, col, val


def sort_compress(row, col, val, m: int, out_capacity: int, val_dtype=None):
    """Stage-3b/4: sort products by (row, col), merge duplicates, emit CSR
    arrays. Returns (rowptr, out_col, out_val)."""
    val_dtype = val_dtype or val.dtype
    dev = row.device
    key, perm = torch.sort((row << 32) | col)
    val = val[perm]
    row = key >> 32
    col = key & 0xFFFFFFFF
    valid = row < m
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    is_head = key != prev
    seg = torch.cumsum(is_head.long(), 0) - 1
    head_valid = is_head & valid

    counts = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, row, head_valid.long())
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:m], 0)])

    # each run summed in order (segment_reduce over the runs' lengths,
    # not a float index-add, whose atomics add in no fixed order); the
    # invalid tail and runs past out_capacity go to the dump run
    # `out_capacity`
    seg_sum = torch.where(valid, seg, out_capacity).clamp(max=out_capacity)
    lengths = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    lengths.index_add_(0, seg_sum, torch.ones_like(seg_sum))
    out_val = torch.segment_reduce(val, "sum", lengths=lengths, unsafe=True)
    tgt = torch.where(head_valid, seg, out_capacity).clamp(max=out_capacity)
    out_col = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    out_col[tgt] = col
    return (
        rowptr.to(INDEX_DTYPE),
        out_col[:out_capacity].to(INDEX_DTYPE),
        out_val[:out_capacity].to(val_dtype),
    )


@dataclasses.dataclass(frozen=True)
class EscPlan:
    """The two capacities of ``spgemm_esc_padded``, static in the
    reference's jit."""

    prod_capacity: int
    out_capacity: int


def spgemm_esc_padded(a: CSR, b: CSR, prod_capacity: int,
                      out_capacity: int) -> CSR:
    """C = A @ B with static buffer sizes.

    ``prod_capacity`` must be >= total intermediate products (stage-1
    bound); ``out_capacity`` must be >= nnz(C) (prod_capacity suffices).
    On the card one CUDA graph per (capacities, operand shapes) from the
    second call (``ops/graphs``).
    """
    from . import graphs

    return graphs.run(_spgemm_esc, EscPlan(prod_capacity, out_capacity),
                      a, b)


def _spgemm_esc(a: CSR, b: CSR, plan: EscPlan) -> CSR:
    """The eager body of ``spgemm_esc_padded``."""
    row, col, val = expand_products(a, b, plan.prod_capacity)
    rowptr, out_col, out_val = sort_compress(
        row, col, val, a.m, plan.out_capacity, a.vals.dtype
    )
    return CSR(rowptr=rowptr, colidx=out_col, vals=out_val, shape=(a.m, b.n))
