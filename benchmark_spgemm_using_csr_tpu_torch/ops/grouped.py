"""Grouped-ESC SpGEMM: product-balanced ROW GROUPS turn the global product
sort into one (G, W) 2D sort with group-LOCAL packed keys.

SpGEMM never needs a global sort: products only merge within one C row.
The host plan assigns whole rows to product-balanced groups of a static
slot capacity, lays the chunk stream out group-strided, and every group is
sorted independently by one ``torch.sort(dim=1)``. The key packs
``(local_row << cbits) | col`` with local row ids that need only the bits
of one group's rows, chosen at plan time so lbits + cbits <= 32.

Pipeline:

1. host plan: quantize per-entry products to chunks (narrow k == 1 or
   al-aligned), greedily fill rows into groups of ``cs`` chunk slots under
   the rows-per-group key-bit cap, build per-row slot offsets;
2. device: propagate per-entry constants onto the group-strided chunk
   stream (ops/stream machinery), expand products via a per-product
   gather or whole rows of an al-aligned B table with sentinel pad lanes;
3. ONE 2D sort of the keys along the group axis, values gathered by the
   sort's permutation;
4. run-sum + compaction (``stream.runsum_compact_scan``), rowptr via an
   (m+1)-gather into the tail cumsum at host-known sorted offsets.

What differs from the reference package's ``ops/grouped.py``: keys are
int64 with the sentinel 2**32 - 1 (the reference sorts uint32); values
stay in their own dtype end to end (float64 is native on the card, so the
reference's hi/lo float32 double-word lane is not carried; bfloat16 and
float16 products are formed and summed in float32, as the reference's
float32 lane does); the tail is
always the run-sum scan (no ``tail_mode``/``disp_bits``); per-slot A
values come from a propagated entry id and one gather; the sort-pin hook
is not carried.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, acc_dtype, host_view
from ..utils import profiling
from .stream import (
    SENTINEL_U32,
    aligned_table,
    at_row_starts,
    ones,
    pad_gentle,
    propagate_entry_consts,
    runsum_compact_scan,
    scatter,
)
from .symbolic import exact_nnz_c


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """Statics for one matrix structure profile."""

    k: int  # chunk width: 1 (narrow) or al (aligned table rows)
    al: int  # 0 = narrow per-pair gathers; >0 = al-aligned table (k == al)
    cs: int  # chunk slots per group
    g_cap: int  # padded group count
    abpad_cap: int  # aligned-table capacity in pairs (0 when al == 0)
    out_cap: int  # padded exact nnzC
    nnz_c: int  # exact structural nnz(C) (symbolic.exact_nnz_c)
    cbits: int  # column bits in the packed (local_row, col) key
    lbits: int  # local-row bits (max rows per group fits)
    max_run: int  # run-sum pass bound (max nnz of any A row, padded)
    scatter_set: bool  # collision-free scatter-SET propagation

    @property
    def s_cap(self) -> int:  # chunk-slot stream length
        return self.g_cap * self.cs

    @property
    def lanes(self) -> int:
        return self.al if self.al else self.k

    @property
    def prod_cap(self) -> int:  # product-slot stream length
        return self.s_cap * self.lanes


def estimate_mode_ns(
    m: int, nnz_a: int, slots: int, desc: int, abpad: int
) -> float:
    """Grouped-pipeline cost in ns, with the reference package's
    constants (measured on a TPU v5e, not yet calibrated for the H100):
    per-slot cost with a log2(width)^2 bitonic-depth term, ~5.5 ns per
    gather descriptor, ~10 ns per A entry, ~20 ns per row. The plan and
    the dispatcher only use the ordering it gives."""
    w_est = int(np.clip(slots / 64, 1 << 13, 1 << 17))
    lb = max(int(w_est - 1).bit_length(), 1)
    return (
        slots * (2.0 + 0.009 * lb * lb)
        + (desc + abpad) * 5.5
        + nnz_a * 10.0
        + m * 20.0
    )


@dataclasses.dataclass(frozen=True)
class GroupedSchedule:
    """Plan + structure-derived device tensors (built once per
    structure, the stage-2 binning result)."""

    plan: GroupedPlan
    slot0: torch.Tensor  # (m,) int32 first chunk slot per row (group-strided)
    first_rank: torch.Tensor  # (g_cap,) int32 nonempty rows before each group
    sorted_off: torch.Tensor  # (m + 1,) int32 product-slot offset of each
    # row's sorted position: group base + within-group product prefix
    fill_end: torch.Tensor  # (g_cap,) int32 absolute first padding slot per
    # group (group base + fill)


def make_grouped_plan(
    a: CSR, b: CSR, al: int | None = None, target_slots: int | None = None,
    fixed: GroupedPlan | None = None,
    force_scatter_set: bool | None = None,
    nnz_c: int | None = None,
) -> GroupedSchedule | None:
    """Host stage-2: chunk quantization -> greedy row->group packing.

    al: None sweeps {narrow k=1, aligned al=2/4/8} with the cost model;
    0 forces narrow; >0 forces that table alignment. Returns None when the
    matrix doesn't fit the regime (empty, values not float32, bfloat16,
    float16 or float64, a
    key that cannot fit 32 bits, or more than 2**27 products). The
    schedule's tensors live on a.device.

    fixed: build this matrix's schedule under another plan's statics
    (mode, cs, g_cap, capacities), so that one plan serves several row
    blocks (ops/batched); the statics must cover this matrix (checked).
    force_scatter_set: override the scatter-SET choice.
    nnz_c: the exact nnz(C), where the caller has counted it already
    (ops/batched); None counts it here (``symbolic.exact_nnz_c``: kernel
    K5 on the card, scipy's pattern product on the CPU).
    """
    m, n = a.m, b.n
    if m == 0 or n == 0:
        return None
    if fixed is not None:
        al = fixed.al
    if a.vals.dtype not in (torch.float32, torch.bfloat16, torch.float16,
                            torch.float64):
        return None
    a_rowptr = host_view(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    lens = b_len[host_view(a.colidx)[:nnz_a]]
    total = int(lens.sum())
    if fixed is None and (total == 0 or total > (1 << 27)):
        return None
    if total > (1 << 27):
        raise ValueError("fixed statics cannot cover this product stream")

    cbits = max(int(n - 1).bit_length(), 1)
    if cbits > 31:
        return None
    # mode selection: narrow k=1 (no padding) vs al-aligned tables over
    # al in {2, 4, 8}, with the reference's table-size guard
    if al is None:
        al, best = 0, estimate_mode_ns(m, nnz_a, total, total, 0)
        for cand in (2, 4, 8):
            slots_c = int((-(-lens // cand)).sum()) * cand
            abpad_c = int((-(-b_len // cand) * cand).sum())
            nrows_c = abpad_c // cand
            if nrows_c > (512 << 10 if cand < 8 else 2 << 20):
                continue
            cost_c = estimate_mode_ns(
                m, nnz_a, slots_c, slots_c // cand, abpad_c
            )
            if cost_c < best:
                al, best = cand, cost_c
    lanes = al if al else 1

    # per-entry chunk counts and per-row chunk sums
    chunks_e = -(-lens // lanes)
    if fixed is not None:
        scatter_set = fixed.scatter_set
    elif force_scatter_set is not None:
        scatter_set = force_scatter_set
    else:
        n_zero = int((chunks_e == 0).sum())
        scatter_set = n_zero <= max(nnz_a // 16, 64)
    if scatter_set:
        chunks_e = np.maximum(chunks_e, 1)
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    row_chunks = (cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]).astype(np.int64)
    max_chunks = int(row_chunks.max(initial=1))
    total_chunks = int(cce[-1])

    # rows per group are capped so the packed key stays below the all-ones
    # 32-bit sentinel; the chunk cap is swept to minimize the padded stream
    max_rows_cap = (1 << min(32 - cbits, 30)) - 1
    if max_rows_cap < 1:
        return None

    cum_chunks = cce[a_rowptr]  # (m + 1,) chunks before each row
    ne_flag = (row_chunks > 0).astype(np.int64)
    cum_ne = np.concatenate([[0], np.cumsum(ne_flag)])

    def greedy(cap: int):
        """Greedy row->group boundaries under chunk cap + row-key cap
        (row order preserved -> the flat sorted stream is row-ordered)."""
        bounds = [0]
        r = 0
        while r < m:
            nb_c = int(
                np.searchsorted(cum_chunks, cum_chunks[r] + cap, "right") - 1
            )
            nb_r = int(
                np.searchsorted(cum_ne, cum_ne[r] + max_rows_cap, "right") - 1
            )
            nb = min(max(nb_c, r + 1), max(nb_r, r + 1), m)
            bounds.append(nb)
            r = nb
        return np.asarray(bounds, np.int64)

    if fixed is not None:
        bounds = greedy(fixed.cs)
        fills = cum_chunks[bounds[1:]] - cum_chunks[bounds[:-1]]
        cs = fixed.cs
        if int(fills.max(initial=0)) > cs:
            raise ValueError("fixed cs too small for this matrix")
    else:
        if target_slots is None:
            cap0 = int(
                np.clip(total_chunks * lanes / 64, 1 << 13, 1 << 17)
            ) // lanes
        else:
            cap0 = -(-target_slots // lanes)
        best = None
        for cap in {max(cap0, max_chunks), max(cap0 // 2, max_chunks),
                    max(cap0 // 4, max_chunks), max(cap0 * 2, max_chunks)}:
            bounds = greedy(cap)
            fills = cum_chunks[bounds[1:]] - cum_chunks[bounds[:-1]]
            cs_try = int(fills.max(initial=1))
            padded = pad_gentle(len(bounds) - 1, minimum=1) * cs_try
            # depth-aware cost: every padded slot rides the whole pipeline
            # plus a sort whose per-element cost grows with log2(width)^2
            w_try = cs_try * lanes
            sort_ns = 0.0035 * 0.5 * max(int(w_try - 1).bit_length(), 1) ** 2
            cost = padded * (8.0 + sort_ns)
            if best is None or cost < best[0]:
                best = (cost, bounds, fills, cs_try)
        _, bounds, fills, cs = best
    n_groups = len(bounds) - 1
    tile_of = np.searchsorted(bounds, np.arange(m), "right") - 1
    base_chunk = cum_chunks[:m] - cum_chunks[bounds[tile_of]]
    if fixed is not None:
        if n_groups > fixed.g_cap:
            raise ValueError("fixed g_cap too small for this matrix")
        g_cap = fixed.g_cap
    else:
        g_cap = pad_gentle(n_groups, minimum=1)
    first_rank_l = list(cum_ne[bounds[:-1]])
    rank = int(cum_ne[m])
    fill_end = np.zeros(g_cap, np.int64)
    fill_end[:n_groups] = fills
    fill_end += np.arange(g_cap, dtype=np.int64) * cs  # absolute slot
    first_rank = np.zeros(g_cap, np.int32)
    first_rank[: len(first_rank_l)] = first_rank_l
    first_rank[len(first_rank_l):] = rank
    ranks = np.asarray(first_rank_l + [rank])
    max_rows_group = int(np.diff(ranks).max(initial=1))
    lbits = max(int(max_rows_group - 1).bit_length(), 1)
    if lbits + cbits > 32:
        return None

    prod_cap = g_cap * cs * lanes

    # per-row sorted product offset: group base + within-group VALID
    # product prefix (each row's valid products occupy a host-known span
    # of its group's sorted stream, before the group's sentinel tail)
    lens_prefix = np.concatenate([[0], np.cumsum(lens)])
    row_vp = lens_prefix[a_rowptr]  # (m + 1,) valid products before row r
    # subtract each group's first nonempty row's prefix; groups with no
    # nonempty row keep -1 and their rows sit at the group base
    seen = np.full(n_groups, -1, np.int64)
    nonempty = np.nonzero(row_chunks > 0)[0]
    groups, first = np.unique(tile_of[nonempty], return_index=True)
    seen[groups] = row_vp[nonempty[first]]
    sg = seen[tile_of]
    within = np.where(sg >= 0, np.maximum(row_vp[:m] - sg, 0), 0)
    sorted_off = (tile_of * (cs * lanes) + within).astype(np.int64)
    sorted_off_full = np.concatenate(
        [sorted_off, [int(prod_cap)]]
    ).astype(np.int32)

    max_run = int(
        1 << max(int(np.diff(a_rowptr).max(initial=1) - 1).bit_length(), 0)
    )
    if fixed is not None:
        if max_run > fixed.max_run:
            raise ValueError("fixed max_run too small for this matrix")
        plan = fixed
    else:
        plan = _new_plan(a, b, b_len, al, lanes, cs, g_cap, prod_cap,
                         cbits, lbits, max_run, scatter_set, nnz_c)
    slot0 = (tile_of * cs + base_chunk).astype(np.int32)
    dev = a.device
    # four blocking copies to the device
    profiling.count("host.syncs", 4)
    return GroupedSchedule(
        plan=plan,
        slot0=torch.from_numpy(slot0).to(dev),
        first_rank=torch.from_numpy(first_rank).to(dev),
        sorted_off=torch.from_numpy(sorted_off_full).to(dev),
        fill_end=torch.from_numpy(fill_end.astype(np.int32)).to(dev),
    )


def _new_plan(a, b, b_len, al, lanes, cs, g_cap, prod_cap, cbits, lbits,
              max_run, scatter_set, nnz_c=None) -> GroupedPlan:
    """The plan's capacities that need the exact nnz(C) (counted by
    ``symbolic.exact_nnz_c`` unless given) and the aligned table's size."""
    if nnz_c is None:
        nnz_c = exact_nnz_c(a, b)
    abpad_cap = 0
    if al:
        abpad = int((-(-b_len // al) * al).sum())
        # +al guarantees >= 1 all-sentinel table row past the aligned
        # region for dummy chunks of zero-length B rows
        abpad_cap = max(-(-pad_gentle(abpad + al) // al) * al, al)
    return GroupedPlan(
        k=lanes,
        al=al,
        cs=int(cs),
        g_cap=int(g_cap),
        abpad_cap=int(abpad_cap),
        out_cap=min(pad_gentle(max(nnz_c, 1)), prod_cap),
        nnz_c=nnz_c,
        cbits=cbits,
        lbits=lbits,
        max_run=max_run,
        scatter_set=bool(scatter_set),
    )


def spgemm_grouped(a: CSR, b: CSR, sched: GroupedSchedule) -> CSR:
    """C = A @ B via grouped per-row sorts (module docstring); on the card
    one CUDA graph per plan from the second call (``ops/graphs``). Counts,
    eager or replayed, the product slots the call expands, sorts and
    run-sums (``grouped.slots``: the plan's ``prod_cap``)."""
    from . import graphs

    with profiling.span("grouped.spgemm"):
        profiling.count("grouped.slots", sched.plan.prod_cap)
        return graphs.run(_spgemm_grouped, sched.plan, a, b, sched.slot0,
                          sched.first_rank, sched.sorted_off, sched.fill_end)


def _spgemm_grouped(a: CSR, b: CSR, slot0, first_rank, sorted_off, fill_end,
                    plan: GroupedPlan) -> CSR:
    """The eager body of ``spgemm_grouped``: no value read on the host."""
    m, n = a.m, b.n
    dev = a.device
    al, lanes = plan.al, plan.lanes
    S = plan.s_cap  # chunk slots
    W = plan.cs * lanes  # product slots per group
    acol = a.colidx.long()
    entry_valid = a.row_ids() < m

    # ---- per-entry chunk metadata -> group-strided slot destinations ----
    if al:
        nrows_tbl = plan.abpad_cap // al
        # pad lanes hold col == -1: lane validity comes from the table,
        # not from a remaining length
        pstart, tbl_col, tbl_val = aligned_table(b, al, nrows_tbl)
        per_nz = torch.where(entry_valid, b.row_lengths().long()[acol], 0)
        # zero-product entries (dummy chunks under scatter-SET) read the
        # guaranteed all-sentinel pad region past the aligned table
        p_start = torch.where(per_nz > 0, pstart[acol], plan.abpad_cap - al)
    else:
        rp = b.rowptr.long()
        per_nz = torch.where(entry_valid, rp[acol + 1] - rp[acol], 0)
        # k == 1: dummy/invalid chunks are marked through pos's sign
        p_start = torch.where(per_nz > 0, rp[acol], -1)

    n_chunks_per = (per_nz + (lanes - 1)) // lanes
    if plan.scatter_set:
        n_chunks_per = torch.where(
            entry_valid, torch.clamp(n_chunks_per, min=1), 0
        )
    ends = torch.cumsum(n_chunks_per, 0)
    starts = ends - n_chunks_per
    arp = a.rowptr.long()
    row_chunk_start = at_row_starts(a, ends)

    # first slot per entry: fs = starts + (slot0[row] - row_chunk_start),
    # the bracket spread to entries by a row-boundary delta scatter
    g_row = slot0.long() - row_chunk_start[:-1]
    d_g = g_row - torch.cat([g_row.new_zeros(1), g_row[:-1]])
    spread = scatter(a.capacity, arp[:-1], d_g, accumulate=True)
    fs = starts + torch.cumsum(spread, 0)

    # posb propagation with group-boundary liveness injections: -BIG at
    # each group's fill end and +BIG at each group base (g >= 1), so every
    # slot past a group's fill carries pos < 0 and `pos >= 0` is the
    # complete liveness mask (dummy chunks already propagate pos == -1)
    BIG = 1 << 30
    q_posb = p_start - lanes * fs
    d_pb = q_posb - torch.cat([q_posb.new_zeros(1), q_posb[:-1]])
    acc = scatter(S, fs, d_pb, accumulate=not plan.scatter_set)
    g_bases = torch.arange(1, plan.g_cap, dtype=torch.int64, device=dev) * plan.cs
    fill_end = fill_end.long()
    acc = acc + scatter(
        S, torch.cat([g_bases, fill_end]),
        torch.cat([torch.full_like(g_bases, BIG),
                   torch.full_like(fill_end, -BIG)]),
        accumulate=True,
    )
    posb = torch.cumsum(acc, 0)
    # per-slot A value: propagate the entry id, then one gather
    eid = propagate_entry_consts(
        fs, (torch.arange(a.capacity, device=dev),), S,
        use_set=plan.scatter_set,
    )[0]
    a_val = a.vals.to(acc_dtype(a.vals.dtype))[
        torch.clamp(eid, 0, a.capacity - 1)]
    s_ids = torch.arange(S, dtype=torch.int64, device=dev)
    pos = posb + lanes * s_ids
    row_chunks = row_chunk_start[1:] - row_chunk_start[:-1]

    # ---- expansion ------------------------------------------------------
    if al:
        trow = torch.clamp(pos // al, 0, nrows_tbl - 1)
        col = tbl_col[trow]  # (S, al)
        val = tbl_val[trow] * a_val[:, None]
        lv = (pos >= 0)[:, None] & (col >= 0)
    else:
        gidx = torch.clamp(pos, 0, b.capacity - 1)
        col = b.colidx.long()[gidx][:, None]
        val = (b.vals[gidx] * a_val)[:, None]
        lv = (pos >= 0)[:, None]

    # ---- group-local packed keys ----------------------------------------
    # nonempty-row rank per slot minus the group's first rank = local row
    hits_r = scatter(
        S + 1, torch.where(row_chunks > 0, slot0.long(), S),
        ones(row_chunks), accumulate=True,
    )
    rank = torch.cumsum(hits_r[:S], 0)  # 1-based
    lr = rank - 1 - first_rank.long().repeat_interleave(plan.cs)
    key = torch.where(lv, (lr << plan.cbits)[:, None] | col, SENTINEL_U32)
    valm = torch.where(lv, val, 0)

    # ---- ONE 2D sort: every group independently --------------------------
    okey, perm = torch.sort(key.reshape(plan.g_cap, W), dim=1)
    oval = torch.gather(valm.reshape(plan.g_cap, W), 1, perm)

    # ---- run-sum + compaction; rowptr at host-known sorted offsets -------
    keyc, valc, tails_cum = runsum_compact_scan(
        okey.reshape(-1), oval.reshape(-1), w=W, out_cap=plan.out_cap,
        max_run=plan.max_run,
    )
    exc = torch.cat([tails_cum.new_zeros(1), tails_cum])
    rowptr = exc[torch.clamp(sorted_off.long(), 0, exc.shape[0] - 1)]
    oc = torch.arange(plan.out_cap, device=dev)
    keep = oc < rowptr[-1]
    out_col = torch.where(keep, keyc & ((1 << plan.cbits) - 1), 0)
    out_val = torch.where(keep, valc, 0).to(a.vals.dtype)
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=out_col.to(INDEX_DTYPE),
               vals=out_val, shape=(m, n))
