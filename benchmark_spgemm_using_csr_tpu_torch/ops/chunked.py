"""Chunked-ESC SpGEMM: the shape-generic sort-based numeric core.

Pipeline (one product stream, static capacities from the host plan):

1. **Chunk split.** Each A entry (i, j, a_v) contributes len(B_j)
   products. The segment is split into ceil(len/K) chunks of K; per-chunk
   metadata (row, B position, remaining length, a_v bits) is
   *delta-propagated*: each entry's delta against the previous entry is
   scattered at its first chunk and a cumsum spreads it
   (``stream.propagate_entry_consts``).
2. **Expansion.** Chunk c reads B's (col, val) at [start_c, start_c + K)
   (``_expand_chunks``), whole rows of an al-aligned copy of B
   (``_expand_aligned``), or, for long B rows, whole rows of a
   128-lane-aligned copy (``_expand_wide``). Invalid lanes get row m.
3. **Sort** the flat product stream by one int64 key
   ``row << cbits | col``.
4. **Run-sum + compaction** of duplicate (row, col) runs
   (``stream.merge_products``); rowptr is one (m+1)-gather into the
   tail-count cumsum at the per-row product offsets.

Steps 3-4 and the helpers the other methods share are ``ops/stream``;
this module is chunked's plan and expansions, and ``make_dist_local_plan``,
the same plan cut per row block (the distributed schedules and the
out-of-core blocks).

**The row-local route.** Where every row of the product fits kernel K6
(``ops/rowlocal``: at most 8192 products a row, and shared memory for two
blocks an SM) and no expansion mode is asked for, ``make_chunked_plan`` sets
``rowlocal`` (K6's launch) and sizes C at ``pad_gentle(nnz(C))``, the
exact count. The call then makes no product stream: K5 counts C's rows and
K6 expands, orders, sums and writes each row on chip. Shard and block plans
(``make_dist_local_plan``) keep the stream: a shard's C is not the whole C.

What differs from the reference package's ``ops/chunked.py``:

- The key is a single int64 for every (m, n), so the reference's 2-key
  sort fallback, its uint32 pack with the (m-1, n-1) corner splice and the
  ``pack_u32`` plan field do not exist here; the resulting CSR is the
  same.
- The post-sort tail is always the run-sum + scatter compaction, so the
  ``disp_bits`` and ``tail_mode`` plan fields (the reference's TPU shift
  compaction) and the CPU-only ``b_pack`` gather option are not carried.
- JAX's dropped out-of-range scatters become scatters into one extra dump
  slot past the end (``stream.scatter``); int32 delta propagation runs in
  int64, so nothing relies on two's-complement wraparound.
- The row-local route (above): the field ``rowlocal``, C's exact
  ``out_cap``, and each (row, col)'s sum in (value bits) order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, host_view, pad_bucket
from ..utils import profiling
from . import rowlocal as rl
from .stream import (
    F32_PACKABLE,
    aligned_table,
    bits_f32,
    f32_bits,
    merge_products,
    ones,
    pad_gentle,
    propagate_entry_consts,
    row_product_offsets,
    row_stream,
    scatter,
)
from .symbolic import exact_nnz_rows

WIDE_LANES = 128  # padded-B table row width of the wide path


@dataclasses.dataclass(frozen=True)
class ChunkedPlan:
    """Static capacities for one matrix profile (built on the host)."""

    k: int  # chunk width (products per slice-gather)
    chunks_cap: int  # padded number of chunks
    out_cap: int  # padded nnzC bound
    max_run: int = 0  # padded max duplicates per (row, col); 0 = unbounded
    # wide-row path: A entries whose B row has len >= wide_min expand from
    # a wide_lanes-aligned padded copy of B. 0 disables.
    wide_min: int = 0
    wchunks_cap: int = 0  # padded count of wide_lanes-wide chunks
    bpad_cap: int = 0  # padded-B capacity (multiple of wide_lanes)
    wide_lanes: int = WIDE_LANES
    # collision-free scatter-SET propagation: every real entry owns >= 1
    # chunk (zero-product entries get one all-invalid dummy chunk)
    scatter_set: bool = False
    # aligned short-row expansion: al > 0 (== k) expands short rows from an
    # al-aligned copy of B, al pairs per table row
    al: int = 0
    abpad_cap: int = 0  # aligned-table capacity in pairs (multiple of al)
    # mixed mode: with al > 0, entries whose B row has len < al_min take
    # the narrow k=1 substream. 0 = single mode.
    al_min: int = 0
    nchunks_cap: int = 0  # narrow-substream chunk capacity (k=1 chunks)
    # the row-local route (module docstring): K6's launch, or None for the
    # stream; on the route out_cap is pad_gentle(nnz(C))
    rowlocal: rl.RowLocal | None = None

    @property
    def prod_cap(self) -> int:
        return (
            self.chunks_cap * self.k
            + self.nchunks_cap
            + self.wchunks_cap * self.wide_lanes
        )

    @property
    def slots(self) -> int:
        """Product slots a call holds: K6's staged products on the route,
        else the stream's ``prod_cap``."""
        return self.rowlocal.slots if self.rowlocal else self.prod_cap


def make_chunked_plan(
    a: CSR, b: CSR, k: int | None = None, wide_min: int | None = None,
    wide_lanes: int = WIDE_LANES, al: int | None = None,
    al_min: int | None = None, rowlocal: bool = True,
) -> ChunkedPlan:
    """Host stage-2: chunk width, expansion mode and capacities.

    The mode choice prices the candidates with the reference package's
    cost constants, measured on a TPU v5e (not yet calibrated for the
    H100), so the stream's fields equal the reference's plan field for
    field. With ``rowlocal`` and no explicit mode (k, wide_min, al,
    al_min), a product whose rows all fit K6 takes the row-local route
    (module docstring): its nnz(C) is counted per row
    (``symbolic.exact_nnz_rows``: K5 on the card) and C sized at it."""
    explicit_mode = any(x is not None for x in (k, wide_min, al, al_min))
    a_rowptr = host_view(a.rowptr).astype(np.int64)
    b_len = np.diff(host_view(b.rowptr).astype(np.int64))
    nnz_a = int(a_rowptr[-1])
    lens_all = b_len[host_view(a.colidx)[:nnz_a]]
    # per-row product counts nnzCt (ops/symbolic.nnz_upper_bound, on host)
    cum = np.concatenate([[0], np.cumsum(lens_all)])
    nnz_ct = cum[a_rowptr[1:]] - cum[a_rowptr[:-1]]
    total = int(nnz_ct.sum())

    # wide-row split: entries with len >= wide_min take the aligned wide
    # path when those entries carry a dominant share of long products
    explicit_wide = wide_min is not None
    if wide_min is None:
        wide_min = 96
    wide_mask = lens_all >= wide_min if wide_min else np.zeros(0, bool)
    wide_products = int(lens_all[wide_mask].sum()) if wide_min else 0
    mean_wide_len = wide_products / max(int(wide_mask.sum()), 1)
    use_wide = (
        wide_min > 0
        and wide_products > 0
        and (
            explicit_wide
            or (wide_products >= total * 0.3 and mean_wide_len >= 1024)
        )
    )
    if use_wide:
        lens_w = lens_all[wide_mask]
        lens = lens_all[~wide_mask]
        wchunks = int(np.ceil(lens_w / wide_lanes).sum())
        blen_wide = b_len[b_len >= wide_min]
        bpad = int((np.ceil(blen_wide / wide_lanes) * wide_lanes).sum())
        wchunks_cap = pad_gentle(max(wchunks, 1))
        bpad_cap = max(
            -(-pad_gentle(max(bpad, 1)) // wide_lanes) * wide_lanes,
            wide_lanes,
        )
    else:
        wide_min = 0
        lens = lens_all
        wchunks_cap = 0
        bpad_cap = 0

    # short-row expansion mode: narrow per-pair gather (chunk width k) vs
    # al-aligned table rows; TPU v5e constants of the reference package
    AL_DESC_RATES = {8: 1.82e8, 16: 1.23e8}
    SORT_NS, PAIR_NS, CHUNK_NS = 3.9, 5.5, 1.0
    al_packable = a.vals.dtype in F32_PACKABLE
    abpad_cap = 0
    blen_nw = b_len[b_len < wide_min] if use_wide else b_len

    def _narrow_cost(c):
        ch = int(np.ceil(lens / c).sum())
        return (SORT_NS + PAIR_NS) * ch * c + CHUNK_NS * ch

    if al:  # explicit aligned width
        if k is None:
            k = al
        if al_min is None:
            al_min = 0
    elif k is None and lens.size:
        mean_len = max(float(lens.mean()), 1.0)
        n_cands = sorted(
            {1, 2}
            | {int(np.clip(round(mean_len * f), 4, 256))
               for f in (0.5, 0.75, 1.0, 1.5, 2.0)}
        )
        best = min((_narrow_cost(c), 0, c) for c in n_cands)
        if al is None and al_packable:
            for w, rate in AL_DESC_RATES.items():
                ch = int(np.ceil(lens / w).sum())
                bpad_w = int((np.ceil(blen_nw / w) * w).sum())
                layout_ns = 0.085 * (128 / (2 * w))
                cost = (
                    (SORT_NS + 1e9 / (w * rate) + layout_ns) * ch * w
                    + CHUNK_NS * ch
                    + PAIR_NS * bpad_w
                )
                if cost < best[0]:
                    best = (cost, w, w)
        _, al, k = best
        al_min = 0
    al = al or 0
    al_min = (al_min or 0) if al else 0
    if al and not al_packable:
        raise ValueError("aligned expansion requires float32, bfloat16 or "
                         "float16 values")
    if k is None:
        k = 1
    k = min(k, b.capacity)
    if al:
        al = k
        mask_mid = blen_nw >= al_min if al_min else np.ones(
            blen_nw.shape, bool
        )
        bpad = int((np.ceil(blen_nw[mask_mid] / al) * al).sum())
        abpad_cap = max(
            -(-pad_gentle(max(bpad, 1)) // al) * al, al
        )
    # chunks: per A entry ceil(len(B_col)/K); mixed mode splits aligned
    # chunks (len >= al_min) from narrow k=1 chunks (len < al_min)
    if al and al_min:
        chunks = int(np.ceil(lens[lens >= al_min] / al).sum())
        nchunks = int(lens[lens < al_min].sum())
    else:
        chunks = int(np.ceil(lens / k).sum()) if nnz_a else 0
        nchunks = 0
    # scatter-SET propagation needs every entry to own >= 1 chunk in each
    # substream it is propagated over; enable when those dummy slots stay a
    # small fraction of the product stream
    n_zero_len = int((lens == 0).sum()) if nnz_a else 0
    n_wide_e = int(wide_mask.sum()) if wide_min else 0
    if al and al_min:
        nd_aligned = int((lens < al_min).sum()) + n_wide_e
        nd_narrow = int((lens >= al_min).sum()) + n_zero_len + n_wide_e
        extra_slots = nd_aligned * al + nd_narrow
        total_slots = chunks * al + nchunks
        scatter_set = extra_slots <= max(total_slots // 16, 64)
        if scatter_set:
            chunks += nd_aligned
            nchunks += nd_narrow
    else:
        extra_chunks = n_zero_len + n_wide_e
        scatter_set = extra_chunks <= max(chunks // 16, 64)
        if scatter_set:
            chunks += extra_chunks
    # duplicates of one (row, col) are bounded by that A-row's nnz
    a_len_max = int(np.diff(a_rowptr).max(initial=1))

    out_bound = min(total, int(np.minimum(nnz_ct, b.n).sum()))
    route = None
    if (rowlocal and not explicit_mode and a.m and b.vals.dtype == a.vals.dtype
            and int(nnz_ct.max(initial=0)) <= rl.MAX_PRODUCTS):
        nnz_c_rows = exact_nnz_rows(a, b)
        route = rl.make_launch(nnz_ct, nnz_c_rows, a.vals.dtype)
        if route is not None and route.smem <= rl.SMEM_MAX:
            out_bound = int(nnz_c_rows.sum())
        else:
            route = None

    return ChunkedPlan(
        k=k,
        chunks_cap=pad_gentle(max(chunks, 1)),
        out_cap=pad_gentle(max(out_bound, 1)),
        max_run=pad_bucket(a_len_max),
        wide_min=wide_min,
        wchunks_cap=wchunks_cap,
        bpad_cap=bpad_cap,
        wide_lanes=wide_lanes,
        scatter_set=scatter_set,
        al=al,
        abpad_cap=abpad_cap,
        al_min=al_min,
        nchunks_cap=pad_gentle(max(nchunks, 1)) if (al and al_min) else 0,
        rowlocal=route,
    )


def make_dist_local_plan(
    a: CSR, b: CSR, n_shards: int, halo_lens: list | None = None,
    bounds: np.ndarray | None = None,
) -> ChunkedPlan:
    """One ChunkedPlan for every row shard: the whole matrix's mode
    decisions (k, al-aligned tables, wide split, scatter-SET, all
    per-matrix) with the capacities the max over the shards.

    halo_lens: per-shard arrays of the assembled halo's B row lengths (the
    halo schedule of ``parallel/halo``): the aligned and wide tables are
    sized on the halo, not on the whole B.

    bounds: explicit row boundaries (n_shards + 1,), for non-uniform
    shards (``parallel/dist.balanced_row_bounds``) and the out-of-core
    path's product-balanced blocks (``ops/batched``); default the uniform
    partition of ``parallel/dist.shard_rows``.
    """
    base = make_chunked_plan(a, b, rowlocal=False)
    if base.al_min:  # mixed mode is never picked by the plan; keep it pure
        base = make_chunked_plan(a, b, al=base.al)

    m = a.m
    m_loc = -(-m // n_shards)
    rowptr = host_view(a.rowptr).astype(np.int64)
    nnz_a = int(rowptr[-1])
    rowptr_full = np.concatenate(
        [rowptr, np.full(n_shards * m_loc - m, rowptr[-1], np.int64)]
    )
    if bounds is None:
        row_bounds = np.arange(n_shards + 1) * m_loc
    else:
        row_bounds = np.asarray(bounds, np.int64)
        if len(row_bounds) != n_shards + 1:
            raise ValueError(f"{len(row_bounds)} bounds for {n_shards} shards")
    bounds_e = rowptr_full[row_bounds]
    b_len = np.diff(host_view(b.rowptr)).astype(np.int64)
    lens_all = b_len[host_view(a.colidx)[:nnz_a]]

    def seg_sum(x):  # per-shard sums of an entry-level array
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

    # per-shard output bound: sum over the shard's rows of min(products, n)
    prod_row = np.concatenate([[0], np.cumsum(lens_all, dtype=np.int64)])
    row_prod = prod_row[rowptr_full[1:]] - prod_row[rowptr_full[:-1]]
    oc = np.concatenate([[0], np.cumsum(np.minimum(row_prod, b.n),
                                        dtype=np.int64)])
    out_max = int(
        (oc[np.minimum(row_bounds[1:], m)]
         - oc[np.minimum(row_bounds[:-1], m)]).max(initial=1)
    )

    abpad_cap, bpad_cap = base.abpad_cap, base.bpad_cap
    if halo_lens is not None:
        # the table builds run against each shard's assembled halo B
        if base.al:
            def _abpad(hl):
                sel = hl < base.wide_min if base.wide_min else np.ones(
                    hl.shape, bool
                )
                return int((-(-hl[sel] // base.al) * base.al).sum())

            abpad = max(_abpad(hl) if hl.size else 0 for hl in halo_lens)
            abpad_cap = max(
                -(-pad_gentle(max(abpad, 1) + base.al) // base.al) * base.al,
                base.al,
            )
        if base.wide_min:
            bpad = max(
                int((np.ceil(hl[hl >= base.wide_min] / base.wide_lanes)
                     * base.wide_lanes).sum()) if hl.size else 0
                for hl in halo_lens
            )
            bpad_cap = max(
                -(-pad_gentle(max(bpad, 1)) // base.wide_lanes)
                * base.wide_lanes,
                base.wide_lanes,
            )

    return dataclasses.replace(
        base,
        chunks_cap=pad_gentle(chunks_max),
        wchunks_cap=pad_gentle(wchunks_max) if base.wide_min else 0,
        out_cap=pad_gentle(out_max),
        abpad_cap=abpad_cap,
        bpad_cap=bpad_cap,
        nchunks_cap=0,
        al_min=0,
    )


def _expand_chunks(a: CSR, b: CSR, k: int, chunks_cap: int,
                   wide_min: int = 0, scatter_set: bool = False):
    """Chunk metadata + slice-gather product expansion.

    Returns flat int64 (row, col) and (val) of shape (chunks_cap * k,);
    invalid slots carry row == m. wide_min > 0 skips entries whose B row
    has len >= wide_min (they expand via _expand_wide instead).
    """
    m = a.m
    dev = a.device
    entry_valid = a.row_ids() < m
    rp = b.rowptr.long()
    acol = a.colidx.long()
    b_start = rp[acol]
    per_nz = torch.where(entry_valid, rp[acol + 1] - b_start, 0)
    if wide_min:
        per_nz = torch.where(per_nz >= wide_min, 0, per_nz)
    n_chunks_per = (per_nz + (k - 1)) // k
    if scatter_set:
        # every real entry owns >= 1 chunk -> collision-free scatter-SET
        n_chunks_per = torch.where(
            entry_valid, torch.clamp(n_chunks_per, min=1), 0
        )
    ends = torch.cumsum(n_chunks_per, 0)
    starts = ends - n_chunks_per
    c_ids = torch.arange(chunks_cap, dtype=torch.int64, device=dev)
    chunk_valid = c_ids < ends[-1]
    row = row_stream(a, ends, chunks_cap)

    # pos[c] = (b_start - k*starts)[e] + k*c, rem[c] = (per_nz + k*starts)[e]
    # - k*c: both brackets are entry constants. k == 1: every real chunk is
    # one product; dummy chunks are marked through pos's sign instead of a
    # remaining-length propagation.
    need_rem = k > 1
    if need_rem:
        q_posb = b_start - k * starts
    else:
        q_posb = torch.where(per_nz > 0, b_start, -1) - starts
    q_remb = per_nz + k * starts
    deltas = (q_posb, q_remb) if need_rem else (q_posb,)
    if a.vals.dtype in F32_PACKABLE:
        outs = propagate_entry_consts(
            starts, deltas + (f32_bits(a.vals),), chunks_cap,
            use_set=scatter_set,
        )
        a_val = bits_f32(outs[-1])
    else:
        outs = propagate_entry_consts(
            starts, deltas, chunks_cap, use_set=scatter_set,
        )
        hits = scatter(chunks_cap, starts, ones(starts), accumulate=True)
        src = torch.clamp(torch.cumsum(hits, 0) - 1, 0, a.capacity - 1)
        a_val = a.vals[src]
    pos = outs[0] + k * c_ids
    if need_rem:
        rem = outs[1] - k * c_ids
    else:
        rem = (pos >= 0).long()

    # (k, chunks) lane-major layout; the order is irrelevant to the sort.
    # Clip per-lane indices, never the segment start: only masked lanes
    # are clamped.
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    lane_valid = chunk_valid[None, :] & (lane[:, None] < rem[None, :])
    gidx = torch.clamp(pos[None, :] + lane[:, None], 0, b.capacity - 1)
    col = b.colidx.long()[gidx]
    val = b.vals[gidx] * a_val[None, :]
    row_t = torch.where(lane_valid, row[None, :], m)
    col_t = torch.where(lane_valid, col, 0)
    val_t = torch.where(lane_valid, val, 0)
    return row_t.reshape(-1), col_t.reshape(-1), val_t.reshape(-1)


def _expand_aligned(a: CSR, b: CSR, al: int, chunks_cap: int,
                    abpad_cap: int, wide_min: int = 0,
                    scatter_set: bool = False, al_min: int = 0):
    """Expansion via an al-aligned copy of B (``stream.aligned_table``):
    products arrive as whole al-lane table rows, masked by the remaining
    length like narrow-chunk tails. Requires float32-packable values (the
    plan guarantees this).

    Returns flat (row, col, val) of shape (chunks_cap * al,); invalid slots
    carry row == m. wide_min > 0 skips entries with len >= wide_min;
    al_min > 0 skips entries with len < al_min (the narrow substream of
    mixed mode takes them).
    """
    m = a.m
    dev = a.device
    nrows_tbl = abpad_cap // al

    b_len_all = b.row_lengths().long()
    sel = (b_len_all < wide_min) if wide_min else torch.ones_like(
        b_len_all, dtype=torch.bool
    )
    if al_min:
        sel = sel & (b_len_all >= al_min)
    pstart, tbl_col, tbl_val = aligned_table(b, al, nrows_tbl, sel)

    # ---- chunk stream over A entries --------------------------------------
    entry_valid = a.row_ids() < m
    acol = a.colidx.long()
    p_start = pstart[acol]
    per_nz = torch.where(entry_valid, b_len_all[acol], 0)
    if wide_min:
        per_nz = torch.where(per_nz >= wide_min, 0, per_nz)
    if al_min:
        per_nz = torch.where(per_nz < al_min, 0, per_nz)
    n_chunks_per = (per_nz + (al - 1)) // al
    if scatter_set:
        n_chunks_per = torch.where(
            entry_valid, torch.clamp(n_chunks_per, min=1), 0
        )
    ends = torch.cumsum(n_chunks_per, 0)
    starts = ends - n_chunks_per
    c_ids = torch.arange(chunks_cap, dtype=torch.int64, device=dev)
    chunk_valid = c_ids < ends[-1]
    row = row_stream(a, ends, chunks_cap)

    posb, remb, aval_bits = propagate_entry_consts(
        starts,
        (p_start - al * starts, per_nz + al * starts, f32_bits(a.vals)),
        chunks_cap, use_set=scatter_set,
    )
    a_val = bits_f32(aval_bits)
    pos = posb + al * c_ids  # al-aligned for valid chunks
    rem = remb - al * c_ids

    trow = torch.clamp(pos // al, 0, nrows_tbl - 1)
    col = tbl_col[trow]  # (chunks_cap, al)
    val = tbl_val[trow] * a_val[:, None]
    lane = torch.arange(al, dtype=torch.int64, device=dev)
    lane_valid = chunk_valid[:, None] & (lane[None, :] < rem[:, None])
    row_t = torch.where(lane_valid, row[:, None], m)
    col_t = torch.where(lane_valid, col, 0)
    val_t = torch.where(lane_valid, val, 0)
    return row_t.reshape(-1), col_t.reshape(-1), val_t.reshape(-1)


def _expand_wide(a: CSR, b: CSR, wide_min: int, wchunks_cap: int,
                 bpad_cap: int, wide_lanes: int = WIDE_LANES):
    """Long-B-row expansion: B's long rows are scattered once into a
    wide_lanes-aligned padded copy, and each long row's products arrive as
    whole table rows. Returns a flat (row, col, val) stream of
    wchunks_cap * wide_lanes slots; invalid slots carry row == m.
    """
    m = a.m
    dev = a.device
    L = wide_lanes
    nrows_tbl = bpad_cap // L

    # ---- padded-B tables --------------------------------------------------
    b_len = b.row_lengths().long()
    ws = torch.where(b_len >= wide_min, ((b_len + L - 1) // L) * L, 0)
    pstart = torch.cat([ws.new_zeros(1), torch.cumsum(ws, 0)])[:-1]
    b_rows = b.row_ids().long()
    b_rows_c = torch.clamp(b_rows, max=b.m - 1)
    entry_wide = (b_rows < b.m) & (b_len[b_rows_c] >= wide_min)
    off = torch.arange(b.capacity, device=dev) - b.rowptr.long()[b_rows_c]
    tgt = torch.where(entry_wide, pstart[b_rows_c] + off, bpad_cap)
    tblc = scatter(bpad_cap, tgt, b.colidx.long(),
                   accumulate=False).reshape(nrows_tbl, L)
    tblv = scatter(bpad_cap, tgt, b.vals, accumulate=False).reshape(
        nrows_tbl, L
    )

    # ---- wide chunk stream over A entries ---------------------------------
    av = a.row_ids() < m
    rp = b.rowptr.long()
    acol = a.colidx.long()
    per_nz = torch.where(av, rp[acol + 1] - rp[acol], 0)
    wide_e = av & (per_nz >= wide_min)
    pn = torch.where(wide_e, per_nz, 0)
    n_w = (pn + L - 1) // L
    wends = torch.cumsum(n_w, 0)
    wstarts = wends - n_w
    wc = torch.arange(wchunks_cap, dtype=torch.int64, device=dev)
    wvalid = wc < wends[-1]

    p0 = torch.where(wide_e, pstart[acol], 0)  # L-aligned base
    row = row_stream(a, wends, wchunks_cap)
    q_posb = p0 - L * wstarts
    q_remb = pn + L * wstarts
    if a.vals.dtype in F32_PACKABLE:
        posb, remb, avalb = propagate_entry_consts(
            wstarts, (q_posb, q_remb, f32_bits(a.vals)), wchunks_cap
        )
        a_val = bits_f32(avalb)
    else:
        posb, remb = propagate_entry_consts(
            wstarts, (q_posb, q_remb), wchunks_cap
        )
        hits = scatter(wchunks_cap, wstarts, ones(wstarts), accumulate=True)
        src = torch.clamp(torch.cumsum(hits, 0) - 1, 0, a.capacity - 1)
        a_val = a.vals[src]
    trow = torch.clamp((posb + L * wc) // L, 0, nrows_tbl - 1)
    rem = remb - L * wc
    lane = torch.arange(L, dtype=torch.int64, device=dev)
    lv = wvalid[:, None] & (lane[None, :] < rem[:, None])
    col = tblc[trow]
    val = tblv[trow] * a_val[:, None]
    row_t = torch.where(lv, row[:, None], m)
    col_t = torch.where(lv, col, 0)
    val_t = torch.where(lv, val, 0)
    return row_t.reshape(-1), col_t.reshape(-1), val_t.reshape(-1)


def spgemm_chunked(a: CSR, b: CSR, plan: ChunkedPlan) -> CSR:
    """C = A @ B through the chunked sort-based merge, or on the row-local
    route through K6 (module docstring); on the card one CUDA graph per
    plan from the second call (``ops/graphs``). Counts, eager or replayed,
    the product slots the call holds (``chunked.slots``: the stream's
    expanded, sorted and run-summed slots, or K6's staged products), the
    slots C is sized at (``chunked.out_slots``) and, on the route, the rows
    K6 takes (``chunked.rowlocal_rows``)."""
    from . import graphs

    with profiling.span("chunked.spgemm"):
        profiling.count("chunked.slots", plan.slots)
        profiling.count("chunked.out_slots", plan.out_cap)
        if plan.rowlocal:
            profiling.count("chunked.rowlocal_rows", a.m)
        return graphs.run(_spgemm_chunked, plan, a, b)


def _spgemm_chunked(a: CSR, b: CSR, plan: ChunkedPlan) -> CSR:
    """The eager body of ``spgemm_chunked``: no value read on the host."""
    if plan.rowlocal:
        return rl.rowlocal_esc(a, b, plan.rowlocal, out_cap=plan.out_cap,
                               max_run=plan.max_run)
    m, n = a.m, b.n
    if plan.al:
        row, col, val = _expand_aligned(
            a, b, plan.al, plan.chunks_cap, plan.abpad_cap,
            wide_min=plan.wide_min, scatter_set=plan.scatter_set,
            al_min=plan.al_min,
        )
        if plan.al_min:
            # mixed mode: B rows with len < al_min ride the narrow k=1
            # gather
            row_n, col_n, val_n = _expand_chunks(
                a, b, 1, plan.nchunks_cap, wide_min=plan.al_min,
                scatter_set=plan.scatter_set,
            )
            row = torch.cat([row, row_n])
            col = torch.cat([col, col_n])
            val = torch.cat([val, val_n.to(val.dtype)])
    else:
        row, col, val = _expand_chunks(
            a, b, plan.k, plan.chunks_cap,
            wide_min=plan.wide_min, scatter_set=plan.scatter_set,
        )
    if plan.wide_min:
        row_w, col_w, val_w = _expand_wide(
            a, b, plan.wide_min, plan.wchunks_cap, plan.bpad_cap,
            plan.wide_lanes,
        )
        row = torch.cat([row, row_w])
        col = torch.cat([col, col_w])
        val = torch.cat([val, val_w.to(val.dtype)])
    return merge_products(
        row, col, val, m, n, plan.out_cap, plan.max_run, a.vals.dtype,
        prodstart=row_product_offsets(a, b),
    )
