"""Block-sparse (BSR) SpGEMM: batched dense block products.

For matrices with block-local structure (banded, FEM, dense rows), C = A @ B
on (bm, bk) and (bk, bn) blocks turns the irregular gather/sort problem
into a batched matmul:

1. **block-pair expansion**: every (A block, B block) pair whose inner
   block index matches, through one packed (cap_e, 3) per-entry table
   (A block row, B row start, first pair) gathered once per pair;
2. **duplicate merge** by (block row, block col): a sort of the pair
   metadata (never the payloads) puts every output block's pairs in one
   run and gives each run its output slot; padding pairs go to a dump
   slot past the end;
3. **the products**, streamed over chunks of the sorted pairs: each chunk
   gathers its (p, bm, bk) A blocks and (p, bk, bn) B blocks, multiplies
   them with ``torch.bmm`` in IEEE float32 whatever the caller's TF32
   setting (float64 in native float64), sums each run with
   ``torch.segment_reduce`` and adds the sums into their slots, one add
   per slot and chunk. Every sum runs in a fixed order, so a CUDA graph's
   replay (``ops/graphs``) is bit-equal to the eager call; an index-add of
   every product into its slot is not (float atomics).

Zeros inside blocks are multiplied too, so the work grows with the inverse
block density; the dispatcher weighs that (ops/dispatch.estimate_bsr_s).
A chunk holds at most ``BSR_CHUNK_BYTES`` of gathered B blocks (bk * bn *
itemsize bytes a pair, 64 KB in float32 at (128, 128)), whatever the pair
count; in the reference package XLA fuses the gather into the product.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import (
    BSR,
    CSR,
    INDEX_DTYPE,
    host_view,
    row_ids_from_rowptr,
    sorted_unique,
)
from .dense import ieee_fp32
from .stream import ones, pad_gentle, scatter

BSR_CHUNK_BYTES = 512 << 20  # gathered B blocks a chunk of pairs may hold


@dataclasses.dataclass(frozen=True)
class BsrPlan:
    """Static capacities for one block profile."""

    pairs_cap: int  # padded block-pair count
    out_blocks_cap: int  # padded unique output-block count


def make_bsr_plan(a: BSR, b: BSR) -> BsrPlan:
    a_rp = host_view(a.rowptr)
    b_rp = host_view(b.rowptr)
    nnzb_a = int(a_rp[-1])
    b_len = np.diff(b_rp)
    colidx = host_view(a.colidx)[:nnzb_a]
    pairs = int(b_len[colidx].sum()) if nnzb_a else 0
    # unique C blocks per block row <= min(pairs in row, nb)
    nb = b.shape[1] // b.blocks.shape[2]
    per_entry = b_len[colidx]
    cs = np.concatenate([[0], np.cumsum(per_entry)])
    per_row_pairs = (cs[np.minimum(a_rp[1:], nnzb_a)]
                     - cs[np.minimum(a_rp[:-1], nnzb_a)])
    uniq_bound = int(np.minimum(per_row_pairs, nb).sum())
    return BsrPlan(
        pairs_cap=pad_gentle(max(pairs, 1)),
        out_blocks_cap=pad_gentle(max(uniq_bound, 1)),
    )


def bsr_spgemm(a: BSR, b: BSR, plan: BsrPlan) -> BSR:
    """C = A @ B with A (bm, bk) and B (bk, bn) blocks; C gets (bm, bn).
    On the card one CUDA graph per plan from the second call
    (``ops/graphs``)."""
    from . import graphs

    bk, bk2 = a.blocks.shape[2], b.blocks.shape[1]
    if bk != bk2:
        raise ValueError(f"block inner dims mismatch: {bk} vs {bk2}")
    return graphs.run(_bsr_spgemm, plan, a, b)


def _bsr_spgemm(a: BSR, b: BSR, plan: BsrPlan) -> BSR:
    """The eager body of ``bsr_spgemm``: no value read on the host, and
    every sum in a fixed order (a replay is bit-equal to it)."""
    bm, bk = a.blocks.shape[1], a.blocks.shape[2]
    bn = b.blocks.shape[2]
    mb = a.shape[0] // bm
    nb = b.shape[1] // bn
    P = plan.pairs_cap
    cap_out = plan.out_blocks_cap
    dev = a.device
    cap_e = a.colidx.shape[0]

    # ---- 1. block-pair expansion ------------------------------------------
    a_brows = row_ids_from_rowptr(a.rowptr, cap_e).long()
    acol = a.colidx.long()
    b_rp = b.rowptr.long()
    per = torch.where(a_brows < mb, (b_rp[1:] - b_rp[:-1])[acol], 0)
    ends = torch.cumsum(per, 0)
    starts = ends - per
    hits = scatter(P, starts, ones(starts), accumulate=True)
    src = torch.clamp(torch.cumsum(hits, 0) - 1, 0, cap_e - 1)
    pid = torch.arange(P, device=dev)
    pair_valid = pid < ends[-1]
    # one packed per-entry table, one pair-sized gather
    meta = torch.stack([a_brows, b_rp[acol], starts], dim=1)[src]
    b_idx = torch.clamp(meta[:, 1] + pid - meta[:, 2], 0,
                        b.colidx.shape[0] - 1)
    brow = torch.where(pair_valid, meta[:, 0], mb)
    bcol = torch.where(pair_valid, b.colidx.long()[b_idx], 0)

    # ---- 2. merge duplicates by (brow, bcol): a metadata sort ------------
    limit = mb * nb
    key_s, pid_s = torch.sort(torch.where(pair_valid, brow * nb + bcol, limit))
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    live = key_s < limit
    is_head = (key_s != prev) & live
    uniq_s = torch.cumsum(is_head.long(), 0) - 1
    n_uniq = is_head.sum()
    # each sorted pair's output slot: consecutive runs, padding pairs last
    # in the dump slot
    slot_s = torch.where(live, uniq_s, cap_out)
    a_src, b_src = src[pid_s], b_idx[pid_s]

    # ---- 3. the block products, a chunk of sorted pairs at a time: each
    # chunk's runs summed in order (segment_reduce), then added to their
    # slots, one add per slot and chunk ---------------------------------
    chunk = max(BSR_CHUNK_BYTES // (bk * bn * b.blocks.element_size()), 1)
    out = torch.zeros((cap_out + 1, bm, bn), dtype=a.blocks.dtype, device=dev)
    for lo in range(0, P, chunk):
        hi = min(lo + chunk, P)
        with ieee_fp32():
            prod = torch.bmm(a.blocks[a_src[lo:hi]], b.blocks[b_src[lo:hi]])
        s = slot_s[lo:hi]
        # run j of the chunk is slot s[0] + j; padding pairs past the last
        # run go to run hi - lo, and every run of theirs to the dump slot
        run = torch.clamp(s - s[0], max=hi - lo)
        lengths = scatter(hi - lo + 1, run, ones(run), accumulate=True)
        sums = torch.segment_reduce(prod, "sum", lengths=lengths, axis=0,
                                    unsafe=True)
        j = torch.arange(hi - lo + 1, device=dev)
        tgt = torch.where((lengths > 0) & (j < hi - lo), s[0] + j, cap_out)
        out.index_add_(0, torch.clamp(tgt, max=cap_out), sums)
        del prod, sums
    out_blocks = out[:cap_out]

    # output structure: heads carry (brow, bcol) at slot uniq_s
    head_slot = torch.where(is_head, uniq_s, cap_out)
    brow_s = torch.div(key_s, nb, rounding_mode="floor")
    out_colidx = scatter(cap_out, head_slot, key_s - brow_s * nb,
                         accumulate=False)
    out_brow = scatter(cap_out, head_slot, brow_s - mb, accumulate=False) + mb
    needles = torch.arange(mb + 1, device=dev)
    rowptr = torch.minimum(torch.searchsorted(out_brow, needles), n_uniq)
    return BSR(
        rowptr=rowptr.to(INDEX_DTYPE),
        colidx=out_colidx.to(INDEX_DTYPE),
        blocks=out_blocks,
        shape=(a.shape[0], b.shape[1]),
    )


def spgemm_bsr(a_csr: CSR, b_csr: CSR, block_shape=(8, 128),
               out_block=(8, 128)) -> CSR:
    """CSR -> BSR -> multiply -> CSR, on the operands' device.

    block_shape = (bm, bk) for A; B gets (bk, bn) with bn = out_block[1].
    The blocking and the conversion back go through scipy on the host, and
    zeros inside C's blocks are dropped (entries that cancel numerically
    too), as in the reference package. bfloat16 operands are blocked and
    multiplied in float32 (scipy has no bfloat16), and C is rounded back."""
    bm, bk = block_shape
    bn = out_block[1]
    dev = a_csr.device
    a_b = BSR.from_scipy(a_csr.to_scipy(), block_shape=(bm, bk), device=dev)
    b_b = BSR.from_scipy(b_csr.to_scipy(), block_shape=(bk, bn), device=dev)
    c_b = bsr_spgemm(a_b, b_b, make_bsr_plan(a_b, b_b))
    c = c_b.to_scipy().tocsr()
    c.eliminate_zeros()
    c.sort_indices()
    return CSR.from_scipy(
        c, dtype=torch.promote_types(a_csr.dtype, b_csr.dtype), device=dev)


def block_density(a: CSR, block_shape=(8, 128)) -> float:
    """Mean nnz density inside occupied blocks (the share of useful flops
    if multiplied block-dense)."""
    import scipy.sparse as sp

    bm, bn = block_shape
    sp_a = a.to_scipy()
    m, n = sp_a.shape
    if m % bm or n % bn:
        return 0.0
    nblocks = sp.bsr_matrix(sp_a, blocksize=(bm, bn)).indptr[-1]
    if not nblocks:
        return 1.0
    return sp_a.nnz / (nblocks * bm * bn)


def bsr_viable(
    a: CSR,
    block_shape=(8, 128),
    max_pair_bytes: int = 2 << 30,
    chunked_ns_per_product: float = 15.0,
    bsr_ns_per_pair: float = 50.0,
) -> bool:
    """Cost gate for C = A @ A: shape divisibility, product-block memory,
    and a time comparison per intermediate product against per block pair
    (the reference package's constants, measured on a TPU v5e). Host numpy
    only."""
    bm, bk = block_shape
    m, n = a.shape
    if m % bm or n % bk or m % bk or n % bk:
        return False
    rowptr = host_view(a.rowptr)
    nnz = int(rowptr[-1])
    if not nnz:
        return True
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rowptr))
    cols = host_view(a.colidx)[:nnz].astype(np.int64)
    nbk = n // bk
    a_keys = sorted_unique((rows // bm) * nbk + cols // bk)
    b_keys = sorted_unique((rows // bk) * nbk + cols // bk)
    b_blen = np.bincount(b_keys // nbk, minlength=m // bk)
    pairs = int(b_blen[a_keys % nbk].sum())
    if pairs * bm * bk * 4 > max_pair_bytes:
        return False
    products = int(np.diff(rowptr)[cols].sum())
    return pairs * bsr_ns_per_pair < products * chunked_ns_per_product
