"""The product stream's shared primitives: the bottom layer of the ESC paths.

Every sort-based numeric path (chunked, grouped, tilepack, the distributed
schedules, spadd, aggrap, dense's scan mode) builds a flat stream of
(row, col, val) products, sorts it, and sums and compacts the runs of equal
keys. The helpers they share live here; this module imports nothing else
of ``ops``.

The run-sum (``runsum_compact_scan``): the reference package runs it as
a block-by-block ``lax.scan`` that carries (last key, running sum) across
blocks. Here the whole stream is processed at once, which needs no carry:

- run sums: log-step segmented Hillis–Steele passes, bounded by
  ``max_run``, with equality of (group id, key) as the segment test, so
  runs never cross a group boundary, exactly like the reference; a stream
  of one group compares keys alone;
- run tails: valid slots whose successor is another key or another group;
- ``tails_cum``: an inclusive cumsum of the tail flags;
- compaction: one scatter of each tail to ``tails_cum - 1``.

Keys are int64. The sentinel that marks padding defaults to the
reference's all-ones uint32 key, 2**32 - 1; callers whose keys can exceed
32 bits pass their own.
"""
from __future__ import annotations

import torch

from ..sparse.csr import CSR, INDEX_DTYPE, acc_dtype

F32 = torch.float32
# values that ride as float32 bits through the expansion (the reference's
# packing gates): bfloat16 and float16 products are formed in float32
F32_PACKABLE = (torch.float32, torch.bfloat16, torch.float16)

SENTINEL_U32 = 0xFFFFFFFF
MAX_PRODUCTS = 1 << 27  # the most products of tilepack's or grouped's stream


def pad_gentle(n: int, minimum: int = 8) -> int:
    """Round up to the next m * 2^e with m in [8, 15] — ~6% worst-case waste
    (vs 2x for pow2 buckets) while keeping reuse buckets logarithmic."""
    n = max(int(n), minimum)
    e = max(n.bit_length() - 4, 0)
    return -(-n >> e) << e


def scatter(size: int, idx: torch.Tensor, src: torch.Tensor, *,
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


def ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape, dtype=torch.int64, device=x.device)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32).view(torch.int32)


def bits_f32(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of f32_bits for int64 tensors holding int32 bit patterns."""
    return bits.to(torch.int32).view(F32)


def propagate_entry_consts(starts, deltas_src, chunks_cap: int,
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
        acc = scatter(chunks_cap, starts, d, accumulate=not use_set)
        outs.append(torch.cumsum(acc, 0))
    return outs


def at_row_starts(a: CSR, ends: torch.Tensor) -> torch.Tensor:
    """(m+1,) values of an inclusive per-entry cumsum ``ends`` just before
    each row of A starts (0 for rows that start at entry 0): the exclusive
    prefix at row granularity."""
    arp = a.rowptr.long()
    return torch.where(arp > 0, ends[torch.clamp(arp - 1, min=0)], 0)


def row_stream(a: CSR, ends: torch.Tensor, cap: int) -> torch.Tensor:
    """Row id of each of ``cap`` chunks, given the inclusive cumsum of
    chunks per A entry: +1 at each row's first chunk, cumsum (empty rows
    stack their +1 at the same chunk)."""
    row_chunk_start = at_row_starts(a, ends)
    hits_r = scatter(cap, row_chunk_start[1:], ones(row_chunk_start[1:]),
                     accumulate=True)
    return torch.cumsum(hits_r, 0)


def aligned_table(b: CSR, al: int, nrows_tbl: int, sel=None):
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
    hits = scatter(nrows_tbl, tstart[1:], ones(tstart[1:]), accumulate=True)
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


def shift_compact(kept, disp, arrays):
    """Stable left-compaction: every kept element i moves to i - disp[i]
    (targets are strictly increasing over kept elements). The reference
    package does this in log2(holes) conditional-shift passes; here it is
    one scatter per array. Slots past the compacted prefix hold 0."""
    cap = disp.shape[0]
    tgt = torch.arange(cap, device=disp.device) - disp.long()
    tgt = torch.where(kept, tgt, cap)
    return [scatter(cap, tgt, x, accumulate=False) for x in arrays]


def products_per_nz(a: CSR, b: CSR) -> torch.Tensor:
    """Intermediate products contributed by each stored entry of A.

    Shape (a.capacity,) int32; padding slots contribute 0.
    """
    per_nz = b.row_lengths()[a.colidx.long()]
    valid = a.row_ids() < a.m
    return torch.where(valid, per_nz, 0).to(INDEX_DTYPE)


def gather_products(a: CSR, b: CSR, g: torch.Tensor, valid: torch.Tensor):
    """Map global product indices ``g`` (int64) to their (a_entry, col,
    val) triples. Product ``g`` belongs to A-entry k iff
    ``starts[k] <= g < ends[k]`` (exclusive/inclusive cumsum of per-entry
    product counts). Invalid lanes yield (col=0, val=0). Values come in
    ``acc_dtype`` (bfloat16 products in float32)."""
    per_nz = products_per_nz(a, b).long()
    ends = torch.cumsum(per_nz, 0)
    starts = ends - per_nz
    src = torch.searchsorted(ends, g, right=True)
    src_c = torch.clamp(src, max=a.capacity - 1)
    inner = g - starts[src_c]
    acol = a.colidx.long()[src_c]
    bptr = b.rowptr.long()[acol] + inner
    bptr_c = torch.clamp(bptr, 0, b.capacity - 1)
    col = torch.where(valid, b.colidx.long()[bptr_c], 0)
    dt = acc_dtype(torch.promote_types(a.vals.dtype, b.vals.dtype))
    val = torch.where(valid, a.vals[src_c].to(dt) * b.vals[bptr_c].to(dt), 0)
    return src_c, col, val


def row_product_offsets(a: CSR, b: CSR):
    """(m+1,) cumulative per-row product counts: offsets[i] = # products
    with row < i. The sorted stream groups rows in order, so these are the
    row boundaries of the sorted stream."""
    rp = b.rowptr.long()
    acol = a.colidx.long()
    per_nz = torch.where(a.row_ids() < a.m, rp[acol + 1] - rp[acol], 0)
    return at_row_starts(a, torch.cumsum(per_nz, 0))


def rc_pack_bits(m: int, n: int) -> int:
    """Bits of the reference's packed (row << bits | col) int32 sort key,
    or 0 if it doesn't fit (the cost model distinguishes the two)."""
    col_bits = max(int(n).bit_length(), 1)
    return col_bits if (m + 1) << col_bits < (1 << 31) else 0


# ---------------------------------------------------------------------------
# run-sum + compaction
# ---------------------------------------------------------------------------


def _same_run(key, gid, k: int):
    """Whether slot i (i >= k) continues the run of slot i - k: equal keys,
    and equal group ids where the stream has groups (``gid`` not None)."""
    same = key[k:] == key[:-k]
    if gid is not None:
        same = (gid[k:] == gid[:-k]) & same
    return same


def _segmented_runsum(key, val, max_run: int = 0, gid=None):
    """Sum the runs of equal keys of a sorted stream, runs cut at group
    boundaries (``_same_run``); run tails hold the totals (log-step
    Hillis–Steele shifts).

    max_run: bound on run length — caps the passes at log2(max_run).
    """
    cap = key.shape[0]
    bound = min(max_run, cap) if max_run else cap
    run = val
    k = 1
    while k < bound:
        same = torch.zeros(cap, dtype=torch.bool, device=val.device)
        same[k:] = _same_run(key, gid, k)
        shifted = torch.zeros_like(run)
        shifted[k:] = run[:-k]
        run = run + torch.where(same, shifted, 0)
        k *= 2
    return run


def runsum_compact_scan(okey, oval, *, w: int, out_cap: int, max_run: int,
                        sentinel: int = SENTINEL_U32):
    """(keyc[out_cap], valc[out_cap], tails_cum[S]) from the sorted grouped
    stream.

    okey: (S,) int64 keys sorted within each w-slot group; padding slots
    hold ``sentinel``. oval: (S,) values in the same order. With w >= S the
    stream is one group, and no group id is built or compared.
    keyc/valc: the run tails' keys and run sums, compacted; 0 past the
    last tail. tails_cum: inclusive count of run tails up to each slot.
    """
    s = okey.shape[0]
    dev = okey.device
    gid = None
    if w < s:
        gid = torch.div(torch.arange(s, device=dev), w, rounding_mode="floor")
    run = _segmented_runsum(okey, oval, max_run, gid)
    nxt_same = torch.zeros(s, dtype=torch.bool, device=dev)
    nxt_same[:-1] = _same_run(okey, gid, 1)
    kept = (okey != sentinel) & ~nxt_same
    tails_cum = torch.cumsum(kept, 0)
    tgt = torch.where(kept, tails_cum - 1, out_cap).clamp(max=out_cap)
    keyc = torch.zeros(out_cap + 1, dtype=okey.dtype, device=dev)
    keyc[tgt] = okey
    valc = torch.zeros(out_cap + 1, dtype=oval.dtype, device=dev)
    valc[tgt] = run
    return keyc[:out_cap], valc[:out_cap], tails_cum


def merge_products(row, col, val, m: int, n: int, out_cap: int,
                   max_run: int = 0, val_dtype=None, prodstart=None,
                   by_value=None) -> CSR:
    """Stages 3-4 on a flat product stream (row == m marks invalid slots):
    sort by the int64 key ``row << cbits | col`` -> run-sum + compaction ->
    rowptr.

    prodstart: optional (m+1,) cumulative per-row product counts of the
    stream; when given, rowptr is one (m+1)-gather instead of an
    (m+1)-needle binary search over the sorted stream.

    by_value: optional int64 keys of the values (one a slot); when given,
    the sort is stable and lexicographic by (key, by_value), so every run's
    sum is taken in one fixed order."""
    val_dtype = val_dtype or val.dtype
    cap = row.shape[0]
    cbits = max(int(n - 1).bit_length(), 1)
    sentinel = m << cbits  # above every valid key
    key = torch.where(row < m, (row << cbits) | col, sentinel)
    if by_value is None:
        key, perm = torch.sort(key)
    else:
        _, perm = torch.sort(by_value, stable=True)
        key, second = torch.sort(key[perm], stable=True)
        perm = perm[second]
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
