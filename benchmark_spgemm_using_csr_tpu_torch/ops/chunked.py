"""Chunked-ESC SpGEMM: the shape-generic sort-based numeric core.

Pipeline (one product stream, static capacities from the host plan):

1. **Chunk split.** Each A entry (i, j, a_v) contributes len(B_j)
   products. The segment is split into ceil(len/K) chunks of K; per-chunk
   metadata (row, B position, remaining length, a_v bits) is
   *delta-propagated*: each entry's delta against the previous entry is
   scattered at its first chunk and a cumsum spreads it
   (``_propagate_entry_consts``).
2. **Expansion.** Chunk c reads B's (col, val) at [start_c, start_c + K)
   (``_expand_chunks``), whole rows of an al-aligned copy of B
   (``_expand_aligned``), or, for long B rows, whole rows of a
   128-lane-aligned copy (``_expand_wide``). Invalid lanes get row m.
3. **Sort** the flat product stream by one int64 key
   ``row << cbits | col``.
4. **Run-sum + compaction** of duplicate (row, col) runs
   (``scancompact.runsum_compact_scan``); rowptr is one (m+1)-gather into
   the tail-count cumsum at the per-row product offsets.

What differs from the reference package's ``ops/chunked.py``:

- The key is a single int64 for every (m, n), so the reference's 2-key
  sort fallback, its uint32 pack with the (m-1, n-1) corner splice and the
  ``pack_u32`` plan field do not exist here; the resulting CSR is the
  same.
- The post-sort tail is always the run-sum + scatter compaction, so the
  ``disp_bits`` and ``tail_mode`` plan fields (the reference's TPU shift
  compaction) and the CPU-only ``b_pack`` gather option are not carried.
- JAX's dropped out-of-range scatters become scatters into one extra dump
  slot past the end (``_scatter``); int32 delta propagation runs in int64,
  so nothing relies on two's-complement wraparound.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, host_view, pad_bucket
from ..utils import profiling

F32 = torch.float32
# values that ride as float32 bits through the expansion (the reference's
# packing gates): bfloat16 and float16 products are formed in float32
F32_PACKABLE = (torch.float32, torch.bfloat16, torch.float16)

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

    @property
    def prod_cap(self) -> int:
        return (
            self.chunks_cap * self.k
            + self.nchunks_cap
            + self.wchunks_cap * self.wide_lanes
        )


def pad_gentle(n: int, minimum: int = 8) -> int:
    """Round up to the next m * 2^e with m in [8, 15] — ~6% worst-case waste
    (vs 2x for pow2 buckets) while keeping reuse buckets logarithmic."""
    n = max(int(n), minimum)
    e = max(n.bit_length() - 4, 0)
    return -(-n >> e) << e


def make_chunked_plan(
    a: CSR, b: CSR, k: int | None = None, wide_min: int | None = None,
    wide_lanes: int = WIDE_LANES, al: int | None = None,
    al_min: int | None = None,
) -> ChunkedPlan:
    """Host stage-2: chunk width, expansion mode and capacities.

    The mode choice prices the candidates with the reference package's
    cost constants, measured on a TPU v5e (not yet calibrated for the
    H100), so the plan equals the reference's plan field for field."""
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

    return ChunkedPlan(
        k=k,
        chunks_cap=pad_gentle(max(chunks, 1)),
        out_cap=pad_gentle(max(min(total, int(np.minimum(nnz_ct, b.n).sum())), 1)),
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
    )


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _scatter(size: int, idx: torch.Tensor, src: torch.Tensor, *,
             accumulate: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """``zeros(size).at[idx].add/set(src, mode="drop")`` along the first
    axis: targets outside [0, size) go to one dump slot past the end, which
    is cut off. ``out``, a (size + 1, ...) buffer, takes the scatter in
    place of a new zero buffer (a stream of chunks adding into one)."""
    buf = out if out is not None else torch.zeros(
        (size + 1, *src.shape[1:]), dtype=src.dtype, device=src.device)
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    if accumulate:
        buf.index_add_(0, idx, src)
    else:
        buf[idx] = src
    return buf[:size]


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape, dtype=torch.int64, device=x.device)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32).view(torch.int32)


def _bits_f32(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of _f32_bits for int64 tensors holding int32 bit patterns."""
    return bits.to(torch.int32).view(F32)


def _propagate_entry_consts(starts, deltas_src, chunks_cap: int,
                            use_set: bool = False):
    """Broadcast per-entry integer constants onto the chunk stream without a
    per-chunk gather: scatter each entry's delta against the previous entry
    at its first chunk, then cumsum (int64, so the sums telescope exactly).
    Entries with zero chunks collide additively at the next entry's start,
    where their deltas sum to the correct skip.

    use_set: scatter-SET instead of scatter-add. Only valid when ``starts``
    is strictly increasing over real entries (ChunkedPlan.scatter_set);
    capacity-padding entries then collide only at the never-valid slot
    ``total``.
    """
    outs = []
    for q in deltas_src:
        q = q.long()
        d = q - torch.cat([q.new_zeros(1), q[:-1]])
        acc = _scatter(chunks_cap, starts, d, accumulate=not use_set)
        outs.append(torch.cumsum(acc, 0))
    return outs


def _at_row_starts(a: CSR, ends: torch.Tensor) -> torch.Tensor:
    """(m+1,) values of an inclusive per-entry cumsum ``ends`` just before
    each row of A starts (0 for rows that start at entry 0): the exclusive
    prefix at row granularity."""
    arp = a.rowptr.long()
    return torch.where(arp > 0, ends[torch.clamp(arp - 1, min=0)], 0)


def _row_stream(a: CSR, ends: torch.Tensor, cap: int) -> torch.Tensor:
    """Row id of each of ``cap`` chunks, given the inclusive cumsum of
    chunks per A entry: +1 at each row's first chunk, cumsum (empty rows
    stack their +1 at the same chunk)."""
    row_chunk_start = _at_row_starts(a, ends)
    hits_r = _scatter(cap, row_chunk_start[1:], _ones(row_chunk_start[1:]),
                      accumulate=True)
    return torch.cumsum(hits_r, 0)


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
    row = _row_stream(a, ends, chunks_cap)

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
        outs = _propagate_entry_consts(
            starts, deltas + (_f32_bits(a.vals),), chunks_cap,
            use_set=scatter_set,
        )
        a_val = _bits_f32(outs[-1])
    else:
        outs = _propagate_entry_consts(
            starts, deltas, chunks_cap, use_set=scatter_set,
        )
        hits = _scatter(chunks_cap, starts, _ones(starts), accumulate=True)
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


def _aligned_table(b: CSR, al: int, nrows_tbl: int, sel=None):
    """An al-aligned copy of B as (nrows_tbl, al) tables of columns and
    values: B row r starts at pair ``pstart[r]``, a multiple of al, and
    alignment pad lanes hold col == -1 and val == 0 (so a lane's validity
    can be read out of the table). Rows outside ``sel`` take no space.
    Returns (pstart, tbl_col, tbl_val)."""
    dev = b.device
    b_len = b.row_lengths().long()
    ws = ((b_len + al - 1) // al) * al
    if sel is not None:
        ws = torch.where(sel, ws, 0)
    pstart = torch.cat([ws.new_zeros(1), torch.cumsum(ws, 0)])[:-1]
    # table row -> B row map (+1 at each row's first table row, cumsum)
    tstart = pstart // al
    hits = _scatter(nrows_tbl, tstart[1:], _ones(tstart[1:]), accumulate=True)
    rowid = torch.cumsum(hits, 0)
    rp = b.rowptr.long()
    t_ids = torch.arange(nrows_tbl, dtype=torch.int64, device=dev)
    lane = torch.arange(al, dtype=torch.int64, device=dev)
    src = ((rp[:-1] - pstart)[rowid] + t_ids * al)[:, None] + lane[None, :]
    valid = src < rp[1:][rowid][:, None]
    src = torch.clamp(src, 0, b.capacity - 1)
    return (
        pstart,
        torch.where(valid, b.colidx.long()[src], -1),
        torch.where(valid, b.vals[src], 0),
    )


def _expand_aligned(a: CSR, b: CSR, al: int, chunks_cap: int,
                    abpad_cap: int, wide_min: int = 0,
                    scatter_set: bool = False, al_min: int = 0):
    """Expansion via an al-aligned copy of B (``_aligned_table``):
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
    pstart, tbl_col, tbl_val = _aligned_table(b, al, nrows_tbl, sel)

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
    row = _row_stream(a, ends, chunks_cap)

    posb, remb, aval_bits = _propagate_entry_consts(
        starts,
        (p_start - al * starts, per_nz + al * starts, _f32_bits(a.vals)),
        chunks_cap, use_set=scatter_set,
    )
    a_val = _bits_f32(aval_bits)
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
    tblc = _scatter(bpad_cap, tgt, b.colidx.long(),
                    accumulate=False).reshape(nrows_tbl, L)
    tblv = _scatter(bpad_cap, tgt, b.vals, accumulate=False).reshape(
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
    row = _row_stream(a, wends, wchunks_cap)
    q_posb = p0 - L * wstarts
    q_remb = pn + L * wstarts
    if a.vals.dtype in F32_PACKABLE:
        posb, remb, avalb = _propagate_entry_consts(
            wstarts, (q_posb, q_remb, _f32_bits(a.vals)), wchunks_cap
        )
        a_val = _bits_f32(avalb)
    else:
        posb, remb = _propagate_entry_consts(
            wstarts, (q_posb, q_remb), wchunks_cap
        )
        hits = _scatter(wchunks_cap, wstarts, _ones(wstarts), accumulate=True)
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


def _segmented_runsum(row, col, val, max_run: int = 0):
    """Sum duplicate (row, col) runs of a sorted stream; run tails hold the
    totals (log-step Hillis–Steele shifts).

    max_run: bound on run length — caps the passes at log2(max_run).
    """
    cap = row.shape[0]
    bound = min(max_run, cap) if max_run else cap
    run = val
    k = 1
    while k < bound:
        same = torch.zeros(cap, dtype=torch.bool, device=val.device)
        same[k:] = (row[k:] == row[:-k]) & (col[k:] == col[:-k])
        shifted = torch.zeros_like(run)
        shifted[k:] = run[:-k]
        run = run + torch.where(same, shifted, 0)
        k *= 2
    return run


def _shift_compact(kept, disp, arrays):
    """Stable left-compaction: every kept element i moves to i - disp[i]
    (targets are strictly increasing over kept elements). The reference
    package does this in log2(holes) conditional-shift passes; here it is
    one scatter per array. Slots past the compacted prefix hold 0."""
    cap = disp.shape[0]
    tgt = torch.arange(cap, device=disp.device) - disp.long()
    tgt = torch.where(kept, tgt, cap)
    return [_scatter(cap, tgt, x, accumulate=False) for x in arrays]


def row_product_offsets(a: CSR, b: CSR):
    """(m+1,) cumulative per-row product counts: offsets[i] = # products
    with row < i. The sorted stream groups rows in order, so these are the
    row boundaries of the sorted stream."""
    rp = b.rowptr.long()
    acol = a.colidx.long()
    per_nz = torch.where(a.row_ids() < a.m, rp[acol + 1] - rp[acol], 0)
    return _at_row_starts(a, torch.cumsum(per_nz, 0))


def merge_products(row, col, val, m: int, n: int, out_cap: int,
                   max_run: int = 0, val_dtype=None, prodstart=None) -> CSR:
    """Stages 3-4 on a flat product stream (row == m marks invalid slots):
    sort by the int64 key ``row << cbits | col`` -> run-sum + compaction ->
    rowptr.

    prodstart: optional (m+1,) cumulative per-row product counts of the
    stream; when given, rowptr is one (m+1)-gather instead of an
    (m+1)-needle binary search over the sorted stream."""
    from .scancompact import runsum_compact_scan

    val_dtype = val_dtype or val.dtype
    cap = row.shape[0]
    cbits = max(int(n - 1).bit_length(), 1)
    sentinel = m << cbits  # above every valid key
    key = torch.where(row < m, (row << cbits) | col, sentinel)
    key, perm = torch.sort(key)
    val = val[perm]
    keyc, val_c, cum_tails = runsum_compact_scan(
        key, val, w=cap, out_cap=out_cap, max_run=max_run or cap,
        sentinel=sentinel,
    )
    n_uniq = cum_tails[-1]
    oc = torch.arange(out_cap, device=key.device)
    out_col = torch.where(oc < n_uniq, keyc & ((1 << cbits) - 1), 0)
    out_val = torch.where(oc < n_uniq, val_c, 0).to(val_dtype)

    # rowptr[i] = unique tails strictly before the first element with
    # row >= i
    if prodstart is not None:
        first_ge = torch.clamp(prodstart.long(), 0, cap)
    else:
        needles = torch.arange(m + 1, device=key.device) << cbits
        first_ge = torch.searchsorted(key, needles)
    rowptr = torch.where(
        first_ge > 0, cum_tails[torch.clamp(first_ge - 1, min=0)], 0
    )
    rowptr = torch.minimum(rowptr, n_uniq)
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=out_col.to(INDEX_DTYPE),
               vals=out_val, shape=(m, n))


def spgemm_chunked(a: CSR, b: CSR, plan: ChunkedPlan) -> CSR:
    """C = A @ B through the chunked sort-based merge (module docstring);
    on the card one CUDA graph per plan from the second call
    (``ops/graphs``). Counts the product-stream slots the call expands,
    sorts and run-sums (``chunked.slots``) and the slots C is sized and
    compacted at (``chunked.out_slots``), eager or replayed."""
    from . import graphs

    with profiling.span("chunked.spgemm"):
        profiling.count("chunked.slots", plan.prod_cap)
        profiling.count("chunked.out_slots", plan.out_cap)
        return graphs.run(_spgemm_chunked, plan, a, b)


def _spgemm_chunked(a: CSR, b: CSR, plan: ChunkedPlan) -> CSR:
    """The eager body of ``spgemm_chunked``: no value read on the host."""
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
