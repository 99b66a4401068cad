"""Packed-tile ESC SpGEMM: per-tile sort networks replace the global
product sort for short-row matrices.

The product stream is already grouped by C row (chunks are emitted in
A-entry order), so only within-row order is missing. This path packs
several complete C rows into each ``w``-lane tile row and sorts every tile
independently with the hand-written kernel ``ops/kernels.tile_sort_merge``
(one thread block per tile row, sort + duplicate merge + positions +
per-local-row counts in shared memory).

Pipeline:

1. host plan (structure only): quantize every A entry's products to
   al-aligned chunks, greedy-fill rows into tiles of ``w`` lanes (a row
   never straddles a tile), build per-row slot offsets and
   (tile, local-row) ids;
2. device: propagate per-entry constants onto the tile-slot stream
   (ops/stream machinery) and fetch products as whole al-lane rows of an
   al-aligned copy of B whose pad lanes hold col == -1;
3. ``tile_sort_merge`` on the packed (local_row << cbits | col) keys;
4. rowptr from the per-(tile, local_row) counts (one m-gather + cumsum);
   run tails scattered to their compacted positions (stage 4).

Applicability (make_tilepack_plan returns None otherwise): every C row's
padded product count fits one tile, local-row + column bits fit the int32
key below the sentinel, and the product stream holds at most 2**27
products.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, host_view
from ..utils import profiling
from .stream import (
    F32_PACKABLE,
    MAX_PRODUCTS,
    aligned_table,
    at_row_starts,
    bits_f32,
    f32_bits,
    ones,
    pad_gentle,
    propagate_entry_consts,
    scatter,
    shift_compact,
)
from .symbolic import exact_nnz_c

SENTINEL = 1 << 30
AL = 8  # the chunk quantum: B pairs a table row
MAX_W = 2048  # the widest tile, lanes


@dataclasses.dataclass(frozen=True)
class TilePackPlan:
    """Statics for one matrix structure profile."""

    w: int  # tile lane width (pow2)
    al: int  # chunk quantum (pairs per table row)
    t_cap: int  # padded tile count
    abpad_cap: int  # aligned-B table capacity in pairs (multiple of al)
    out_cap: int  # padded exact nnzC
    nnz_c: int  # exact structural nnz(C) (symbolic.exact_nnz_c)
    cbits: int  # column bits in the packed (local_row, col) key
    scatter_set: bool  # collision-free scatter-SET propagation
    # pow2 >= the actual max rows packed in any tile: the width of the
    # kernel's per-local-row counts and the key's local-row bits
    wlr_eff: int = 0

    @property
    def wlr(self) -> int:
        return self.w // self.al

    @property
    def s_cap(self) -> int:  # chunk-slot stream length
        return self.t_cap * self.wlr


@dataclasses.dataclass(frozen=True)
class TilePackSchedule:
    """Plan + structure-derived device tensors (built once per
    structure)."""

    plan: TilePackPlan
    slot0: torch.Tensor  # (m,) int32 first chunk-slot per row
    q: torch.Tensor  # (m,) int32 flat tile*wlr_eff+lr per row; empty -> t_cap*wlr_eff
    first_rank: torch.Tensor  # (t_cap,) int32 nonempty rows before each tile


def tile_width(
    nnz_a: int, n_zero: int, max_chunks: int, max_chunks_set: int,
    products: int, w: int | None = None, al: int = AL, max_w: int = MAX_W,
) -> tuple[int, bool] | None:
    """The plan's gates before its greedy fill, on the pair's integers
    (``max_chunks{,_set}``: the most chunks of ``al`` in a row of A without
    and with a chunk for each entry whose B row is empty): (w,
    scatter_set), or None where the plan refuses (dtype and empty shapes
    aside). ``csrc/pair_stats.cu``'s ``fill_gate`` mirrors it on the card."""
    if products == 0 or products > MAX_PRODUCTS:
        return None
    scatter_set = n_zero <= max(nnz_a // 16, 64)
    mc = max_chunks_set if scatter_set else max_chunks
    if w is None:
        w = max(128, 1 << int(al * max(mc, 1) - 1).bit_length())
    if al * mc > w or w > max_w or w & (w - 1):
        return None
    return w, scatter_set


def fill_statics(
    n_tiles: int, max_rows: int, abpad: int, n: int, al: int = AL,
) -> tuple[int, int, int, int] | None:
    """The plan's statics after its greedy fill (``n_tiles`` tiles, at most
    ``max_rows`` rows in one; ``abpad`` B pairs aligned to ``al``): (t_cap,
    wlr_eff, cbits, abpad_cap), or None where the local-row and column bits
    pass the key's sentinel."""
    cbits = max(int(n - 1).bit_length(), 1)
    wlr_eff = max(1 << max(int(max_rows - 1).bit_length(), 0), 1)
    if int(wlr_eff - 1).bit_length() + cbits > 30:  # sentinel is 1 << 30
        return None
    # +al guarantees >= 1 all-sentinel table row past the aligned region:
    # dummy chunks of zero-length B rows point there
    abpad_cap = max(-(-pad_gentle(abpad + al) // al) * al, al)
    return pad_gentle(n_tiles), wlr_eff, cbits, abpad_cap


def make_tilepack_plan(
    a: CSR, b: CSR, w: int | None = None, al: int = AL, max_w: int = MAX_W,
) -> TilePackSchedule | None:
    """Host stage-2: quantized chunk counts -> greedy row->tile packing.

    Returns None when the matrix doesn't fit the regime (a row exceeds
    max_w padded products, keys overflow the int32 key, values are not
    float32, bfloat16 or float16 (float64 would lose bits in K1's float32
    lanes), or more than 2**27 products; ``tile_width`` and
    ``fill_statics``). The schedule's tensors live on a.device."""
    m, n = a.m, b.n
    if m == 0 or n == 0 or a.vals.dtype not in F32_PACKABLE:
        return None
    a_rowptr = host_view(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    lens = b_len[host_view(a.colidx)[:nnz_a]]
    chunks_e = -(-lens // al)
    empty = chunks_e == 0
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    cze = np.concatenate([[0], np.cumsum(empty)])
    row_chunks = cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]  # (m,)
    row_zero = cze[a_rowptr[1:]] - cze[a_rowptr[:-1]]
    gate = tile_width(nnz_a, int(empty.sum()),
                      int(row_chunks.max(initial=0)),
                      int((row_chunks + row_zero).max(initial=0)),
                      int(lens.sum()), w, al, max_w)
    if gate is None:
        return None
    w, scatter_set = gate
    if scatter_set:  # an empty B row's entry takes a chunk
        row_chunks = row_chunks + row_zero
    wlr = w // al

    # greedy sequential fill (row order preserved -> the compacted stream
    # is globally (row, col)-ordered)
    tile_of = np.zeros(m, np.int64)
    base_chunk = np.zeros(m, np.int64)
    lr_of = np.zeros(m, np.int64)
    first_rank_l = [0]
    cur = 0  # chunks used in current tile
    cur_lr = 0
    t = 0
    rank = 0
    for r, c in enumerate(row_chunks.tolist()):
        if c == 0:
            tile_of[r] = t
            base_chunk[r] = cur
            lr_of[r] = -1
            continue
        if cur + c > wlr:
            t += 1
            first_rank_l.append(rank)
            cur = 0
            cur_lr = 0
        tile_of[r] = t
        base_chunk[r] = cur
        lr_of[r] = cur_lr
        cur += c
        cur_lr += 1
        rank += 1
    ranks = np.asarray(first_rank_l + [rank])
    statics = fill_statics(t + 1, int(np.diff(ranks).max(initial=1)),
                           int((-(-b_len // al) * al).sum()), n, al)
    if statics is None:
        return None
    t_cap, wlr_eff, cbits, abpad_cap = statics
    first_rank = np.zeros(t_cap, np.int32)
    first_rank[: len(first_rank_l)] = first_rank_l
    first_rank[len(first_rank_l):] = rank

    nnz_c = exact_nnz_c(a, b)

    slot0 = (tile_of * wlr + base_chunk).astype(np.int32)
    q = np.where(
        lr_of >= 0, tile_of * wlr_eff + lr_of, t_cap * wlr_eff
    ).astype(np.int32)

    plan = TilePackPlan(
        w=w,
        al=al,
        t_cap=t_cap,
        abpad_cap=abpad_cap,
        out_cap=pad_gentle(max(nnz_c, 1)),
        nnz_c=nnz_c,
        cbits=cbits,
        scatter_set=scatter_set,
        wlr_eff=wlr_eff,
    )
    dev = a.device
    # three blocking copies to the device
    profiling.count("host.syncs", 3)
    return TilePackSchedule(
        plan=plan,
        slot0=torch.from_numpy(slot0).to(dev),
        q=torch.from_numpy(q).to(dev),
        first_rank=torch.from_numpy(first_rank).to(dev),
    )


def pack_tiles(
    a: CSR, b: CSR, sched: TilePackSchedule
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand the products into the packed tiles that K1 sorts: (t_cap, w)
    int32 keys ``local_row << cbits | col`` (SENTINEL on dead lanes) and
    their float32 products (0 on dead lanes)."""
    plan = sched.plan
    m = a.m
    dev = a.device
    al, W, wlr = plan.al, plan.w, plan.wlr
    S = plan.s_cap
    nrows_tbl = plan.abpad_cap // al

    # ---- aligned B table; alignment-pad lanes store col == -1, so lane
    # validity is read out of the table --------------------------------------
    pstart, tbl_col, tbl_val = aligned_table(b, al, nrows_tbl)

    # ---- per-entry chunk metadata -> tile-slot destinations ---------------
    acol = a.colidx.long()
    entry_valid = a.row_ids() < m
    per_nz = torch.where(entry_valid, b.row_lengths().long()[acol], 0)
    # zero-product entries (dummy chunks under scatter-SET) read the
    # guaranteed all-sentinel pad region past the aligned table
    p_start = torch.where(per_nz > 0, pstart[acol], plan.abpad_cap - al)
    n_chunks_per = (per_nz + (al - 1)) // al
    if plan.scatter_set:
        n_chunks_per = torch.where(
            entry_valid, torch.clamp(n_chunks_per, min=1), 0
        )
    ends = torch.cumsum(n_chunks_per, 0)
    starts = ends - n_chunks_per
    arp = a.rowptr.long()
    row_chunk_start = at_row_starts(a, ends)

    # first tile-slot per entry: fs = starts + (slot0[row] -
    # row_chunk_start[row]), spread to entries by a row-boundary scatter
    slot0 = sched.slot0.long()
    g_row = slot0 - row_chunk_start[:-1]
    d_g = g_row - torch.cat([g_row.new_zeros(1), g_row[:-1]])
    spread = scatter(a.capacity, arp[:-1], d_g, accumulate=True)
    fs = starts + torch.cumsum(spread, 0)

    posb, aval_bits = propagate_entry_consts(
        fs, (p_start - al * fs, f32_bits(a.vals)), S,
        use_set=plan.scatter_set,
    )
    a_val = bits_f32(aval_bits)
    s_ids = torch.arange(S, dtype=torch.int64, device=dev)
    pos = posb + al * s_ids

    # slot validity at row granularity: slot s is live iff
    # s < slot0[row] + row_chunks[row]
    row_chunks = row_chunk_start[1:] - row_chunk_start[:-1]
    rend = slot0 + row_chunks
    d_re = rend - torch.cat([rend.new_zeros(1), rend[:-1]])
    re_acc = scatter(S, torch.clamp(slot0, max=S - 1), d_re, accumulate=True)
    slot_live = s_ids < torch.cumsum(re_acc, 0)

    # ---- expansion gather (al lanes per table row) ------------------------
    trow = torch.clamp(pos // al, 0, nrows_tbl - 1)
    col = tbl_col[trow]  # (S, al)
    val = tbl_val[trow] * a_val[:, None]
    lv = slot_live[:, None] & (col >= 0)

    # ---- local-row ids + packed int32 keys --------------------------------
    hits_r = scatter(
        S + 1, torch.where(row_chunks > 0, slot0, S), ones(row_chunks),
        accumulate=True,
    )
    rank = torch.cumsum(hits_r[:S], 0)  # 1-based nonempty-row rank per slot
    lr = rank - 1 - sched.first_rank.long().repeat_interleave(wlr)
    key = torch.where(lv, (lr << plan.cbits)[:, None] | col, SENTINEL)
    valm = torch.where(lv, val, 0)
    key2 = key.to(torch.int32).reshape(plan.t_cap, W)
    val2 = valm.reshape(plan.t_cap, W).contiguous()
    return key2, val2


def spgemm_tilepack(a: CSR, b: CSR, sched: TilePackSchedule) -> CSR:
    """C = A @ B via packed tiles (module docstring); on the card one CUDA
    graph per plan, K1 inside it, from the second call (``ops/graphs``)."""
    from . import graphs

    return graphs.run(_spgemm_tilepack, sched.plan, a, b, sched.slot0,
                      sched.q, sched.first_rank)


def _spgemm_tilepack(a: CSR, b: CSR, slot0, q, first_rank,
                     plan: TilePackPlan) -> CSR:
    """The eager body of ``spgemm_tilepack``: no value read on the host."""
    from .kernels import tile_sort_merge

    sched = TilePackSchedule(plan, slot0, q, first_rank)
    m, n = a.m, b.n
    dev = a.device
    W = plan.w
    key2, val2 = pack_tiles(a, b, sched)

    # ---- per-tile sort + merge + positions + local-row counts (K1) --------
    okey, oval, pos_t, cnt_lr = tile_sort_merge(
        key2, val2, sentinel=SENTINEL, wlr=plan.wlr_eff, cbits=plan.cbits,
    )

    # ---- rowptr from per-(tile, local-row) counts -------------------------
    # empty rows point at the explicit zero past the counts
    counts_flat = torch.cat([cnt_lr.reshape(-1).long(),
                             cnt_lr.new_zeros(1, dtype=torch.int64)])
    counts_row = counts_flat[sched.q.long()]
    rowptr = torch.cat([counts_row.new_zeros(1), torch.cumsum(counts_row, 0)])

    # ---- compaction: each run tail to its global position (stage 4) -------
    cnt_tile = cnt_lr.long().sum(1)
    tprefix = torch.cumsum(cnt_tile, 0) - cnt_tile
    posf = pos_t.long()
    kept = (posf < W).reshape(-1)
    uniq = (tprefix[:, None] + posf).reshape(-1)
    disp = torch.arange(plan.t_cap * W, device=dev) - uniq
    keyc, valc = shift_compact(
        kept, torch.where(kept, disp, 0), [okey.reshape(-1), oval.reshape(-1)]
    )
    out_col = (keyc[: plan.out_cap] & ((1 << plan.cbits) - 1)).to(INDEX_DTYPE)
    out_val = valc[: plan.out_cap].to(a.vals.dtype)
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=out_col, vals=out_val,
               shape=(m, n))
