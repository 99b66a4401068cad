"""Fused SpGEMM: the four stages (symbolic -> binning -> per-bin numeric ->
compaction) as one call whose only host input is a shape plan.

``make_plan`` computes the buffer capacities once per matrix profile (one
device -> host copy of the per-row product counts). ``spgemm_fused`` then
runs the whole pipeline without reading anything back: bin membership is
computed on the device every call into fixed-capacity row lists, and only
the paddings come from the plan. Capacities are bucket-padded, so matrices
of similar profile share one plan.

What differs from the reference package's ``ops/fused.py``: each bin goes
through kernel K2 (``ops/kernels.bin_sort_compress``) and the ``pos``
scatter of the binned path, where the reference sorts with ``lax.sort``;
the structure is the same, and values differ only in the order of the
additions. The tail's flat expansion (the reference's ``_expand``) is
``esc.expand_products``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..sparse.csr import CSR, csr_gather_rows, host_view, pad_bucket
from .binned import _assemble, _bin_products
from .esc import expand_products, sort_compress
from .symbolic import nnz_upper_bound

DEFAULT_WIDTHS = (8, 32, 128, 512)


@dataclasses.dataclass(frozen=True)
class SpGemmPlan:
    """Static shape plan for one matrix profile (all entries are paddings)."""

    widths: Tuple[int, ...]
    bin_rows: Tuple[int, ...]  # padded row capacity per width bin (0 = bin off)
    tail_rows: int  # padded rows with nnzCt > widths[-1] (0 = no tail)
    tail_nnz_a: int  # padded nnz(A) restricted to tail rows
    tail_prod: int  # padded products of tail rows
    out_cap: int  # padded nnzC upper bound


def make_plan(
    a: CSR, b: CSR, widths: Tuple[int, ...] = DEFAULT_WIDTHS
) -> SpGemmPlan:
    """One device -> host copy: stage-1 bounds -> padded capacities."""
    nnz_ct = nnz_upper_bound(a, b).cpu().numpy().astype(np.int64)
    a_rowptr = host_view(a.rowptr).astype(np.int64)
    bin_rows = []
    prev = 0
    for w in widths:
        cnt = int(((nnz_ct > prev) & (nnz_ct <= w)).sum())
        bin_rows.append(pad_bucket(cnt) if cnt else 0)
        prev = w
    tail = np.nonzero(nnz_ct > widths[-1])[0]
    if tail.size:
        tail_rows = pad_bucket(tail.size)
        tail_nnz_a = pad_bucket(int((a_rowptr[tail + 1] - a_rowptr[tail]).sum()))
        tail_prod = pad_bucket(int(nnz_ct[tail].sum()))
    else:
        tail_rows = tail_nnz_a = tail_prod = 0
    # nnzC <= sum over rows of min(products, n)
    out_cap = pad_bucket(int(np.minimum(nnz_ct, b.n).sum()))
    return SpGemmPlan(
        widths=tuple(widths),
        bin_rows=tuple(bin_rows),
        tail_rows=tail_rows,
        tail_nnz_a=tail_nnz_a,
        tail_prod=tail_prod,
        out_cap=out_cap,
    )


def _rows_where(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The indices of ``mask``'s true entries in order, padded with
    len(mask) to ``size`` (entries past ``size`` are dropped): a
    fixed-capacity ``nonzero`` that reads nothing back to the host."""
    m = mask.shape[0]
    rank = torch.cumsum(mask.long(), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, size)
    rows = torch.full((size + 1,), m, dtype=torch.int64, device=mask.device)
    rows[tgt] = torch.arange(m, device=mask.device)
    return rows[:size]


def spgemm_fused(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """C = A @ B under a shape plan. Bins past the plan's capacities are
    silently truncated: the facade builds the plan from the matrix. On the
    card one CUDA graph per plan, K2 for every bin inside it, from the
    second call (``ops/graphs``)."""
    from . import graphs

    return graphs.run(_spgemm_fused, plan, a, b)


def _spgemm_fused(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """The eager body of ``spgemm_fused``."""
    from .kernels import bin_sort_compress

    n = b.n
    nnz_ct = nnz_upper_bound(a, b).long()
    prodstart = torch.cumsum(nnz_ct, 0) - nnz_ct

    # stage 2 on the device: fixed-capacity bin membership
    pieces = []  # (rows, cols, vals, counts, pos)
    prev = 0
    for w, cap in zip(plan.widths, plan.bin_rows):
        if cap:
            rows = _rows_where((nnz_ct > prev) & (nnz_ct <= w), cap)
            col, val = _bin_products(a, b, rows, nnz_ct, prodstart, w)
            cols_t, vals_t, pos, counts = bin_sort_compress(
                col, val.contiguous(), n_sentinel=n)
            pieces.append((rows, cols_t, vals_t, counts, pos))
        prev = w

    # the tail: rows past the largest width through a flat expand-sort-merge
    c_tail = tail_rows = None
    if plan.tail_rows:
        tail_rows = _rows_where(nnz_ct > plan.widths[-1], plan.tail_rows)
        a_tail = csr_gather_rows(a, tail_rows, plan.tail_nnz_a)
        trow, tcol, tval = expand_products(a_tail, b, plan.tail_prod)
        t_rowptr, t_col, t_val = sort_compress(
            trow, tcol, tval, plan.tail_rows, plan.tail_prod, a.vals.dtype
        )
        c_tail = CSR(t_rowptr, t_col, t_val, (plan.tail_rows, n))

    return _assemble(a, b, pieces, c_tail, tail_rows, plan.out_cap)
