"""Sparse matrix addition C = alpha*A + beta*B on CSR (csrgeam).

Addition is a degenerate merge: concatenate the two operands' (row, col,
val) streams and run the chunked path's sort-merge core
(``stream.merge_products``) on them, where every (row, col) run has
length <= 2, so the run-sum is one shift-add pass. Capacities come from a
frozen AddPlan.

Requires canonical CSR inputs (sorted, duplicate-free columns per row, as
CSR.validate / from_scipy give): a column duplicated inside ONE operand
would break the run bound of 2.

``AddPlan.pack_u32`` and ``disp_bits`` are the reference package's knobs
for its 32-bit sort key and its shift compaction; they are computed as it
computes them and change nothing here, where the key is one int64.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sparse.csr import CSR, host_view
from .stream import merge_products, pad_gentle, rc_pack_bits


@dataclasses.dataclass(frozen=True)
class AddPlan:
    """Static capacities for one (A, B) structural profile."""

    out_cap: int
    pack_u32: bool = False
    disp_bits: int = 0


def make_add_plan(a: CSR, b: CSR) -> AddPlan:
    """Exact union size from a boolean host-side add (O(nnz))."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} + {b.shape}")
    total = int(host_view(a.rowptr)[-1]) + int(host_view(b.rowptr)[-1])
    disp_bits = 0
    union = min(total, a.m * a.n)
    if 0 < total <= (1 << 27):
        pat_a = a.to_scipy().astype(bool)
        pat_b = pat_a if b is a else b.to_scipy().astype(bool)
        union = int((pat_a + pat_b).nnz)
        disp_bits = max(int(total - union).bit_length(), 1)

    m, n = a.shape
    pack_u32 = False
    if rc_pack_bits(m, n) == 0 and m >= 2 and n >= 2:
        cbits = max(int(n - 1).bit_length(), 1)
        rbits = max(int(m - 1).bit_length(), 1)
        pack_u32 = cbits + rbits <= 32
    return AddPlan(
        # never more than the concatenated stream (tiny matrices)
        out_cap=min(pad_gentle(max(union, 1)), a.capacity + b.capacity),
        pack_u32=pack_u32,
        disp_bits=disp_bits,
    )


def spadd_planned(a: CSR, b: CSR, plan: AddPlan, alpha=1.0,
                  beta=1.0) -> CSR:
    """C = alpha*A + beta*B under a plan. On the card one CUDA graph per
    plan from the second call (``ops/graphs``); alpha and beta go in as
    0-d tensors of C's type, as the reference traces them, so other
    scalings replay the same graph."""
    from . import graphs

    dt = torch.promote_types(a.dtype, b.dtype)
    alpha, beta = (torch.full((), x, dtype=dt, device=a.device)
                   for x in (alpha, beta))
    return graphs.run(_spadd, plan, a, b, alpha, beta)


def _spadd(a: CSR, b: CSR, alpha, beta, plan: AddPlan) -> CSR:
    """The eager body of ``spadd_planned``."""
    m, n = a.shape
    dt = alpha.dtype
    # padding slots already carry row == m, the invalid marker
    row = torch.cat([a.row_ids(), b.row_ids()]).long()
    col = torch.cat([a.colidx, b.colidx]).long()
    val = torch.cat([a.vals.to(dt) * alpha, b.vals.to(dt) * beta])
    lens = (a.row_lengths() + b.row_lengths()).long()
    prodstart = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    return merge_products(row, col, val, m, n, plan.out_cap, max_run=2,
                          val_dtype=dt, prodstart=prodstart)


def spadd(a: CSR, b: CSR, alpha=1.0, beta=1.0) -> CSR:
    """C = alpha*A + beta*B (builds the plan, then adds)."""
    return spadd_planned(a, b, make_add_plan(a, b), alpha, beta)
