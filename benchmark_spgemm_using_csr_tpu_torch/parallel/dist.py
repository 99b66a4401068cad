"""Distributed SpGEMM: 1D row partitioning of A and C over a mesh of ranks.

The schedules of the reference package's ``parallel/dist.py``, on
torch.distributed (``parallel/mesh``): every rank runs its shard's body of
what the reference runs under ``jax.shard_map``.

- ``dist_spgemm_replicated``: B on every rank; each rank runs the chunked
  or the grouped single-chip kernel on its rows of A. No communication.
- ``dist_spgemm_ring``: B row-sharded; B blocks rotate around the ring
  (``Mesh.ring_shift``) while each rank expands its A entries against the
  block it holds. The exchange of the next block is posted before the
  expansion and waited for after it. Every product lands at a planned
  position, so one sort-merge at the end gives the rank's C rows.
- ``dist_spadd``: C = alpha*A + beta*B, row by row, with no communication.
- ``parallel/halo``: B row-sharded, the remote B rows fetched by one ragged
  all-to-all.

Sharded form (``ShardedCSR``): per-shard blocks stacked on a leading axis,
``rowptr: (P, m_loc+1)``, ``colidx/vals: (P, cap)``, padded alike. The
host partition keeps it on the CPU, as the reference keeps its stacked
arrays, and ``local_shard`` hands a rank its block on its device. The
plans keep the reference's capacities unified over the shards, although
each rank runs its own program: the plans then equal the reference's, and
the ring's rotating buffers have one size on every rank, which a receive
needs to know.

A schedule returns the rank's own C rows; ``gather_shards`` + ``unshard``
give the whole C on every rank, as ``dist_spgemm`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.chunked import (
    ChunkedPlan,
    make_chunked_plan,
    make_dist_local_plan,
    spgemm_chunked,
)
from ..ops.stream import (
    F32_PACKABLE,
    bits_f32,
    f32_bits,
    merge_products,
    ones,
    pad_gentle,
    propagate_entry_consts,
    scatter,
)
from ..sparse.csr import (
    CSR,
    IdentityMemo,
    acc_dtype,
    host_view,
    pad_bucket,
)
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-sharded CSR. Uniform partition (bounds None): shard i holds rows
    [i*m_loc, (i+1)*m_loc), m padded with empty rows to P*m_loc.
    Product-balanced partition: shard i holds rows [bounds[i],
    bounds[i+1]) at local rows 0..cnt_i, its trailing local rows empty, so
    every shard has the same m_loc while the unified capacities (chunk
    stream, groups, output) fall from the largest shard's towards the
    mean."""

    rowptr: torch.Tensor  # (P, m_loc + 1) local rowptrs, from 0
    colidx: torch.Tensor  # (P, cap)
    vals: torch.Tensor  # (P, cap)
    shape: Tuple[int, int]
    bounds: Tuple[int, ...] | None = None

    @property
    def n_shards(self) -> int:
        return self.rowptr.shape[0]

    @property
    def m_loc(self) -> int:
        return self.rowptr.shape[1] - 1

    @property
    def cap(self) -> int:
        return self.colidx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.rowptr.device


def balanced_row_bounds(a: CSR, b: CSR | None = None,
                        n_shards: int = 1) -> np.ndarray:
    """Product-balanced contiguous row boundaries (n_shards + 1,): rows go
    to shards by cumulative intermediate-product count, so every shard
    carries ~total/P products."""
    b = a if b is None else b
    rowptr = host_view(a.rowptr).astype(np.int64)[: a.m + 1]
    nnz = int(rowptr[-1])
    b_len = np.diff(host_view(b.rowptr).astype(np.int64)[: b.m + 1])
    lens = b_len[host_view(a.colidx)[:nnz].astype(np.int64)]
    cs = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    row_prod = cs[rowptr]  # (m + 1,) products before each row
    targets = row_prod[-1] * np.arange(1, n_shards) // n_shards
    cuts = np.searchsorted(row_prod, targets, side="left")
    bounds = np.concatenate([[0], cuts, [a.m]])
    return np.maximum.accumulate(bounds)  # monotone even on degenerate input


def shard_rows(a: CSR, n_shards: int, cap: int | None = None,
               bounds: np.ndarray | None = None) -> ShardedCSR:
    """Host 1D row partition into the stacked form, on the CPU. Uniform
    (bounds None): m padded to a multiple of n_shards with empty rows.
    Non-uniform: explicit boundaries (``balanced_row_bounds``), every shard
    padded to the most rows with empty trailing rows. Padding rows give
    empty C rows, trimmed by ``unshard``."""
    m, n = a.shape
    rowptr = host_view(a.rowptr)
    colidx = host_view(a.colidx)
    vals = host_view(a.vals)
    if bounds is None:
        m_loc = -(-m // n_shards)
        row_bounds = np.arange(n_shards + 1, dtype=np.int64) * m_loc
        bounds_t = None
    else:
        row_bounds = np.asarray(bounds, np.int64)
        if len(row_bounds) != n_shards + 1:
            raise ValueError(f"{len(row_bounds)} bounds for {n_shards} shards")
        m_loc = int(np.diff(row_bounds).max(initial=1))
        bounds_t = tuple(int(x) for x in row_bounds)
    rowptr_full = np.concatenate(
        [rowptr[: m + 1],
         np.full(max(row_bounds[-1] - m, 0), rowptr[m], rowptr.dtype)]
    )
    starts = rowptr_full[np.minimum(row_bounds[:-1], m)]
    ends = rowptr_full[np.minimum(row_bounds[1:], m)]
    if cap is None:
        cap = pad_bucket(int((ends - starts).max()) if n_shards else 1)
    rp = np.zeros((n_shards, m_loc + 1), np.int32)
    ci = np.zeros((n_shards, cap), np.int32)
    va = np.zeros((n_shards, cap), vals.dtype)
    for i in range(n_shards):
        lo, hi = int(starts[i]), int(ends[i])
        cnt = int(row_bounds[i + 1] - row_bounds[i])
        rp[i, : cnt + 1] = rowptr_full[row_bounds[i]: row_bounds[i + 1] + 1] - lo
        rp[i, cnt + 1:] = rp[i, cnt]  # trailing empty rows
        ci[i, : hi - lo] = colidx[lo:hi]
        va[i, : hi - lo] = vals[lo:hi]
    return ShardedCSR(torch.from_numpy(rp), torch.from_numpy(ci),
                      torch.from_numpy(va).to(a.dtype), (m, n),
                      bounds=bounds_t)


def local_shard(sh: ShardedCSR, rank: int, device=None,
                n_cols: int | None = None) -> CSR:
    """Shard ``rank``'s block as a CSR of shape (m_loc, n_cols or n) on
    ``device`` (default: the sharded form's own)."""
    device = sh.device if device is None else device
    return CSR(rowptr=sh.rowptr[rank].to(device),
               colidx=sh.colidx[rank].to(device),
               vals=sh.vals[rank].to(device),
               shape=(sh.m_loc, sh.shape[1] if n_cols is None else n_cols))


def unshard(c: ShardedCSR) -> CSR:
    """Inverse of ``shard_rows`` (concatenate + repack) on the sharded
    form's device; honours a non-uniform partition. One host read: the
    total nnz."""
    m, n = c.shape
    n_sh, m_loc = c.n_shards, c.m_loc
    dev = c.device
    if c.bounds is not None:
        cnts = np.diff(np.asarray(c.bounds, np.int64))
    else:
        cnts = np.full(n_sh, m_loc, np.int64)
    cnts_t = torch.as_tensor(cnts, device=dev)
    rp = c.rowptr.long()
    nnz_per = rp[torch.arange(n_sh, device=dev), cnts_t]  # real rows' nnz
    total = int(nnz_per.sum())
    keep = (torch.arange(c.cap, device=dev)[None, :] < nnz_per[:, None])
    colidx = torch.zeros(pad_bucket(total), dtype=torch.int32, device=dev)
    vals = torch.zeros(pad_bucket(total), dtype=c.vals.dtype, device=dev)
    colidx[:total] = c.colidx[keep]
    vals[:total] = c.vals[keep]
    off = torch.cumsum(nnz_per, 0) - nnz_per
    rows = torch.arange(m_loc, device=dev)[None, :] < cnts_t[:, None]
    rowptr = torch.cat([rp.new_zeros(1), (rp[:, 1:] + off[:, None])[rows]])
    rowptr = rowptr[: m + 1]  # the uniform partition's padding rows go
    return CSR(rowptr.to(torch.int32), colidx, vals, (m, n))


def gather_shards(c_loc: CSR, mesh: Mesh, shape, bounds=None) -> ShardedCSR:
    """Every rank's C rows (a schedule's result) stacked on every rank: the
    rowptrs (one size everywhere) first, then each rank's exact nnz of
    colidx and values."""
    rp = mesh.all_gather_v(c_loc.rowptr, [c_loc.m + 1] * mesh.size)
    nnz = rp[:, -1].tolist()
    return ShardedCSR(rp, mesh.all_gather_v(c_loc.colidx, nnz),
                      mesh.all_gather_v(c_loc.vals, nnz), tuple(shape),
                      bounds=bounds)


@dataclasses.dataclass(frozen=True)
class DistGroupedPlan:
    """Unified grouped statics + every shard's schedule arrays stacked on a
    leading shard axis (on the CPU); each rank runs its own row."""

    plan: object  # ops.grouped.GroupedPlan
    slot0: torch.Tensor  # (P, m_loc)
    first_rank: torch.Tensor  # (P, g_cap)
    sorted_off: torch.Tensor  # (P, m_loc + 1)
    fill_end: torch.Tensor  # (P, g_cap)

    def schedule(self, rank: int, device):
        """Shard ``rank``'s GroupedSchedule on ``device``."""
        from ..ops.grouped import GroupedSchedule

        return GroupedSchedule(
            plan=self.plan,
            slot0=self.slot0[rank].to(device),
            first_rank=self.first_rank[rank].to(device),
            sorted_off=self.sorted_off[rank].to(device),
            fill_end=self.fill_end[rank].to(device),
        )


def make_dist_grouped_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None
) -> DistGroupedPlan | None:
    """Per-shard grouped schedules under unified statics: pass 1 plans each
    row shard with the whole matrix's mode and group-size target, pass 2
    rebuilds every shard under the max statics (``make_grouped_plan``'s
    ``fixed``). None where the grouped regime rejects the matrix.

    bounds: product-balanced boundaries (``balanced_row_bounds``): equal
    per-shard products put the unified statics near the mean."""
    from ..ops.grouped import make_grouped_plan

    base = make_grouped_plan(a, b)
    if base is None:
        return None
    bp = base.plan
    a_sh = shard_rows(a, n_shards, bounds=bounds)
    subs = [local_shard(a_sh, d, "cpu", n_cols=a.n) for d in range(n_shards)]
    p1 = [
        make_grouped_plan(
            s, b, al=bp.al, target_slots=bp.cs * bp.lanes,
            force_scatter_set=bp.scatter_set,
        )
        for s in subs
    ]
    live = [p.plan for p in p1 if p is not None]
    if not live:
        return None
    cs_u = max(p.cs for p in live)
    g_u = max(p.g_cap for p in live)
    prod_u = g_u * cs_u * bp.lanes
    nnz_max = max(p.nnz_c for p in live)
    unified = dataclasses.replace(
        bp,
        cs=cs_u,
        g_cap=g_u,
        out_cap=min(pad_gentle(max(nnz_max, 1)), prod_u),
        nnz_c=nnz_max,
        max_run=max(p.max_run for p in live),
        lbits=max(p.lbits for p in live),
    )
    scheds = [make_grouped_plan(s, b, fixed=unified) for s in subs]
    return DistGroupedPlan(
        plan=unified,
        slot0=torch.stack([s.slot0 for s in scheds]),
        first_rank=torch.stack([s.first_rank for s in scheds]),
        sorted_off=torch.stack([s.sorted_off for s in scheds]),
        fill_end=torch.stack([s.fill_end for s in scheds]),
    )


def _on_mesh(mesh: Mesh, x: CSR, what: str) -> None:
    if x.device != mesh.device:
        raise ValueError(f"{what} is on {x.device}, the mesh's rank drives "
                         f"{mesh.device}")


# ---------------------------------------------------------------------------
# Replicated-B schedule
# ---------------------------------------------------------------------------


def dist_spgemm_replicated(
    a: ShardedCSR, b: CSR, mesh: Mesh, *, plan: ChunkedPlan | None = None,
    grouped_plan: DistGroupedPlan | None = None,
) -> CSR:
    """This rank's rows of C = A @ B, with A and C row-sharded over the mesh
    and B whole on every rank (on the rank's device).

    The local kernel is the tuned chunked pipeline (``plan`` from
    ``make_dist_local_plan``) or the grouped pipeline (``grouped_plan``
    from ``make_dist_grouped_plan``)."""
    _on_mesh(mesh, b, "B")
    a_loc = local_shard(a, mesh.rank, mesh.device)
    if grouped_plan is not None:
        from ..ops.grouped import spgemm_grouped

        return spgemm_grouped(
            a_loc, b, grouped_plan.schedule(mesh.rank, mesh.device))
    if plan is None:
        raise ValueError("pass plan or grouped_plan")
    return spgemm_chunked(a_loc, b, plan)


# ---------------------------------------------------------------------------
# Ring schedule (B row-sharded, blocks rotate around the ring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingStatics:
    """The static shapes of one (A, B, P) ring schedule."""

    k: int  # chunk width (products per metadata slot)
    chunks_cap: int  # per-rank full chunk-stream capacity
    cap_step: int  # most chunks any (rank, super-block) pair holds
    out_cap: int
    m_loc: int
    k_loc: int
    n_shards: int
    max_run: int = 0
    # hop width H: each rank keeps H consecutive B blocks resident and the
    # ring runs P/H steps over an H-block super-buffer. The same volume
    # moves (H-1 in-subgroup prologue shifts + P/H - 1 super-hops), in 1/H
    # of the steps, at H x the resident B.
    hop: int = 1


@dataclasses.dataclass
class RingPlan:
    """Host-built ring schedule (on the CPU): each shard's A entries
    reordered by the B shard that owns their column, so step s expands one
    contiguous chunk slice; chunks are k products wide, as in the
    single-chip core. Structure only: the values come from the A shards of
    the call (``a_val``), so one plan serves every A of this structure."""

    statics: RingStatics
    a_col: torch.Tensor  # (P, cap_e) reordered local A colidx
    a_ent: torch.Tensor  # (P, cap_e) shard-local entry of each reordered one
    a_row: torch.Tensor  # (P, cap_e) local row of each reordered entry
    chunkptr: torch.Tensor  # (P, P + 1) chunk boundaries per owner block
    rp_glob_pad: torch.Tensor  # (P * k_loc + 1,) padded global B rowptr
    bounds: tuple | None = None  # non-uniform A-row partition (if any)

    def a_val(self, a: ShardedCSR, rank: int) -> torch.Tensor:
        """Shard ``rank``'s A values in the plan's entry order, 0 past its
        entries (the reference's ``a_val`` row), on a's device."""
        vals = a.vals[rank]
        ent = self.a_ent[rank].to(vals.device).long()
        live = self.a_row[rank].to(vals.device) < self.statics.m_loc
        return torch.where(live, vals[ent], 0)


def make_ring_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None,
    hop: int = 1,
) -> RingPlan:
    """Group each shard's A entries by the B shard owning their column and
    quantize the per-entry product segments into k-wide chunks (host, one
    structure pass).

    bounds: product-balanced A-row boundaries (``balanced_row_bounds``).
    hop: blocks per resident super-buffer (``RingStatics.hop``); divides
    n_shards."""
    if n_shards % hop:
        raise ValueError(f"hop {hop} must divide n_shards {n_shards}")
    a_sh = shard_rows(a, n_shards, bounds=bounds)
    m_loc, cap_e = a_sh.m_loc, a_sh.cap
    k_loc = -(-b.m // n_shards)
    k_pad = k_loc * n_shards
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    rp_glob_pad = np.concatenate(
        [b_rowptr, np.full(k_pad - b.m, b_rowptr[-1], np.int64)]
    )

    base = make_chunked_plan(a, b, rowlocal=False)
    k = base.al or base.k  # narrow chunk width from the global cost sweep

    rp = a_sh.rowptr.numpy()
    ci = a_sh.colidx.numpy()
    a_col = np.zeros((n_shards, cap_e), np.int32)
    a_ent = np.zeros((n_shards, cap_e), np.int32)
    a_row = np.full((n_shards, cap_e), m_loc, np.int32)
    chunkptr = np.zeros((n_shards, n_shards + 1), np.int64)
    out_bounds = []
    for d in range(n_shards):
        nnz_d = int(rp[d, -1])
        cols = ci[d, :nnz_d].astype(np.int64)
        rows = np.repeat(
            np.arange(m_loc, dtype=np.int64), np.diff(rp[d].astype(np.int64))
        )
        owner = cols // k_loc
        order = np.argsort(owner, kind="stable")
        a_col[d, :nnz_d] = cols[order]
        a_ent[d, :nnz_d] = order
        a_row[d, :nnz_d] = rows[order]
        chunks_e = -(-b_len[cols[order]] // k)
        ccum = np.concatenate([[0], np.cumsum(chunks_e)])
        # chunk boundary of owner block j = first entry with owner >= j
        firsts = np.searchsorted(owner[order], np.arange(n_shards + 1))
        chunkptr[d] = ccum[firsts]
        pcum = np.concatenate([[0], np.cumsum(b_len[cols])])
        row_prod = pcum[rp[d, 1:]] - pcum[rp[d, :-1]]
        out_bounds.append(int(np.minimum(row_prod, b.n).sum()) or 1)

    # super-window spans: chunks between H-aligned owner boundaries
    super_bounds = chunkptr[:, ::hop]
    statics = RingStatics(
        k=k,
        chunks_cap=pad_gentle(int(chunkptr[:, -1].max(initial=1))),
        cap_step=pad_gentle(int(np.diff(super_bounds, axis=1).max(initial=1))),
        out_cap=pad_gentle(max(out_bounds + [1])),
        m_loc=m_loc,
        k_loc=k_loc,
        n_shards=n_shards,
        max_run=base.max_run,
        hop=hop,
    )
    return RingPlan(
        statics=statics,
        a_col=torch.from_numpy(a_col),
        a_ent=torch.from_numpy(a_ent),
        a_row=torch.from_numpy(a_row),
        chunkptr=torch.from_numpy(chunkptr.astype(np.int32)),
        rp_glob_pad=torch.from_numpy(rp_glob_pad.astype(np.int32)),
        bounds=a_sh.bounds,
    )


def _ring_chunks(plan: RingPlan, rank: int, a_val: torch.Tensor, dev,
                 packable: bool):
    """This rank's whole chunk stream, once a call: per chunk its B
    position within its owner block, its remaining length, its local row,
    its owner block and its A value (``a_val``: the rank's A values in the
    plan's entry order; the single-chip core's delta propagation, with the
    owner riding along)."""
    st = plan.statics
    k, n_sh = st.k, st.n_shards
    a_col = plan.a_col[rank].to(dev).long()
    a_row = plan.a_row[rank].to(dev).long()
    rp_glob = plan.rp_glob_pad.to(dev).long()
    entry_valid = a_row < st.m_loc
    b_len = rp_glob[1:] - rp_glob[:-1]
    bl = torch.where(entry_valid, b_len[a_col], 0)
    n_chunks = (bl + (k - 1)) // k
    ends = torch.cumsum(n_chunks, 0)
    starts = ends - n_chunks
    owner = torch.clamp(a_col // st.k_loc, 0, n_sh - 1)
    # block-local positions: the step indexes the resident super-buffer
    q_posb = (rp_glob[a_col] - rp_glob[owner * st.k_loc]) - k * starts
    q_remb = bl + k * starts
    deltas = (q_posb, q_remb, a_row, owner)
    if packable:
        posb, remb, rowc, own_c, avalb = propagate_entry_consts(
            starts, deltas + (f32_bits(a_val),), st.chunks_cap)
        aval_c = bits_f32(avalb)
    else:
        posb, remb, rowc, own_c = propagate_entry_consts(
            starts, deltas, st.chunks_cap)
        hits = scatter(st.chunks_cap, starts, ones(starts), accumulate=True)
        src = torch.clamp(torch.cumsum(hits, 0) - 1, 0, a_col.shape[0] - 1)
        aval_c = a_val[src]
    c_ids = torch.arange(st.chunks_cap, dtype=torch.int64, device=dev)
    total = ends[-1] if a_col.shape[0] else 0
    rowc = torch.where(c_ids < total, rowc, st.m_loc)
    return posb + k * c_ids, remb - k * c_ids, rowc, own_c, aval_c


def _shift(mesh: Mesh, parts: tuple, offset: int, block: int | None = None):
    """Post one ring_shift per tensor of a resident buffer."""
    return tuple(mesh.ring_shift(t, offset, block) for t in parts)


def _wait(pending: tuple) -> tuple:
    return tuple(p.wait() for p in pending)


def dist_spgemm_ring(a: ShardedCSR, b: ShardedCSR, mesh: Mesh, *,
                     ring_plan: RingPlan) -> CSR:
    """This rank's rows of C = A @ B with A and B row-sharded; B blocks
    ride the ring under ``ring_plan`` (``make_ring_plan`` on A's structure
    and partition; the values are ``a``'s).

    Each step but the last posts the shift of the resident buffer to rank
    r+H, expands its chunk slice against the buffer held now, then waits
    for the next one: on NCCL the exchange runs on NCCL's stream beside
    the expansion, with no device synchronize between steps. The last step
    posts nothing (the reference's loop carry shifts once more and drops
    the result), so one call sends H-1 + (P/H - 1)·H blocks. float32,
    bfloat16 and float16 blocks travel as one (cap_b, 2) int32 tensor
    (column and float32 value bits); float64 as two tensors."""
    st = ring_plan.statics
    if mesh.size != st.n_shards:
        raise ValueError(f"a {st.n_shards}-shard plan on a {mesh.size}-rank "
                         "mesh")
    if (a.n_shards, a.bounds) != (st.n_shards, ring_plan.bounds):
        raise ValueError("A's partition is not the ring plan's")
    my, dev, n = mesh.rank, mesh.device, b.shape[1]
    n_sh, k, cap_step, H = st.n_shards, st.k, st.cap_step, st.hop
    G = n_sh // H
    val_dtype = b.vals.dtype
    packable = val_dtype in F32_PACKABLE
    pos_c, rem_c, rowc, own_c, aval_c = _ring_chunks(
        ring_plan, my, ring_plan.a_val(a, my).to(dev), dev, packable)
    cptr = ring_plan.chunkptr[my].tolist()

    b_ci = b.colidx[my].to(dev).to(torch.int32)
    b_va = b.vals[my].to(dev)
    cap_b = b_ci.shape[0]
    if packable:
        block = (torch.stack([b_ci, f32_bits(b_va)], dim=1),)
    else:
        block = (b_ci, b_va)
    # the resident super-buffer: H consecutive blocks of my subgroup,
    # assembled by H-1 in-subgroup shifts. parts[t] holds block
    # base + (my%H + t)%H, so block base+u sits at slot (u - my%H) % H
    parts = [block]
    for _ in range(1, H):
        parts.append(_wait(_shift(mesh, parts[-1], -1, block=H)))
    cur = tuple(torch.cat([p[j] for p in parts]) for j in range(len(block)))
    my_rot = my % H

    S = G * cap_step * k
    out_row = torch.full((S,), st.m_loc, dtype=torch.int64, device=dev)
    out_col = torch.zeros(S, dtype=torch.int64, device=dev)
    out_val = torch.zeros(S, dtype=torch.float32 if packable else val_dtype,
                          device=dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    steps = torch.arange(cap_step, dtype=torch.int64, device=dev)
    for s in range(G):
        # prefetch the next super-block; the expansion reads cur only
        nxt = _shift(mesh, cur, H) if s + 1 < G else None
        sg = (my // H - s) % G  # the super-block held this hop
        off_chunk = cptr[sg * H]
        live = steps < cptr[sg * H + H] - off_chunk
        idxc = torch.clamp(off_chunk + steps, 0, st.chunks_cap - 1)
        slot = (own_c[idxc] - sg * H - my_rot) % H if H > 1 else 0
        pos_s = pos_c[idxc] + slot * cap_b
        gidx = torch.clamp(pos_s[None, :] + lane[:, None], 0, H * cap_b - 1)
        lane_valid = live[None, :] & (lane[:, None] < rem_c[idxc][None, :])
        if packable:
            tile = cur[0][gidx]  # (k, cap_step, 2)
            colk = tile[..., 0]
            valk = bits_f32(tile[..., 1]) * aval_c[idxc][None, :]
        else:
            colk = cur[0][gidx]
            valk = cur[1][gidx] * aval_c[idxc][None, :]
        row_s = torch.where(live, rowc[idxc], st.m_loc)
        o = s * cap_step * k
        out_row[o: o + cap_step * k] = torch.where(
            lane_valid, row_s[None, :], st.m_loc).reshape(-1)
        out_col[o: o + cap_step * k] = torch.where(
            lane_valid, colk.long(), 0).reshape(-1)
        out_val[o: o + cap_step * k] = torch.where(
            lane_valid, valk, 0).reshape(-1).to(out_val.dtype)
        if nxt is not None:
            cur = _wait(nxt)
    return merge_products(out_row, out_col, out_val, st.m_loc, n, st.out_cap,
                          max_run=st.max_run, val_dtype=val_dtype)


# ---------------------------------------------------------------------------
# Distributed sparse addition (row-sharded, communication-free)
# ---------------------------------------------------------------------------


def dist_spadd(a: CSR, b: CSR, mesh: Mesh, alpha=1.0, beta=1.0) -> CSR:
    """Host-facing C = alpha*A + beta*B: shard the rows, merge each rank's
    rows with no communication (every C row needs only the same row of A
    and B: the degenerate sort-merge, runs of at most 2), gather, unshard.
    bfloat16 and float16 are summed in float32 and rounded once."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} + {b.shape}")
    _on_mesh(mesh, a, "A")
    _on_mesh(mesh, b, "B")
    a_sh = shard_rows_cached(a, mesh.size)
    b_sh = shard_rows_cached(b, mesh.size)
    m_loc, n = a_sh.m_loc, a.n
    dt = torch.promote_types(a.dtype, b.dtype)
    acc = acc_dtype(dt)
    a_loc = local_shard(a_sh, mesh.rank, mesh.device)
    b_loc = local_shard(b_sh, mesh.rank, mesh.device)
    row = torch.cat([a_loc.row_ids(), b_loc.row_ids()]).long()
    col = torch.cat([a_loc.colidx, b_loc.colidx]).long()
    val = torch.cat([a_loc.vals.to(acc) * alpha, b_loc.vals.to(acc) * beta])
    lens = (a_loc.row_lengths() + b_loc.row_lengths()).long()
    prodstart = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    c_loc = merge_products(row, col, val, m_loc, n,
                           pad_bucket(a_sh.cap + b_sh.cap), max_run=2,
                           val_dtype=dt, prodstart=prodstart)
    return unshard(gather_shards(c_loc, mesh, a.shape))


# ---------------------------------------------------------------------------
# The facade and its caches
# ---------------------------------------------------------------------------

# Plans are structure-only (the ring and the halo take A's values from its
# shards at each call) and serve every matrix of the same rowptr and
# colidx; a sharded form is keyed on the values too. Both memos hold the
# keyed tensors weakly (IdentityMemo, as host_view's mirror does): an
# entry leaves when its matrix is freed, and misses once one of its
# tensors was written in place.
_SHARD_CACHE = IdentityMemo(64)
_PLAN_CACHE = IdentityMemo(64)


def shard_rows_cached(a: CSR, n_shards: int) -> ShardedCSR:
    """``shard_rows(a, n_shards)``, memoized on a's buffers."""
    key = (a.rowptr, a.colidx, a.vals)
    hit = _SHARD_CACHE.get(key, (n_shards,))
    if hit is None:
        hit = _SHARD_CACHE.put(key, (n_shards,), shard_rows(a, n_shards))
    return hit


def default_ring_hop(n_shards: int) -> int:
    """P//4 where 4 divides P and P >= 8, else 1."""
    return n_shards // 4 if n_shards % 4 == 0 and n_shards >= 8 else 1


def dist_plan(a: CSR, b: CSR, n_shards: int, schedule: str,
              ring_hop: int | None = None):
    """The schedule's plan for C = A @ B over n_shards ranks, memoized on
    the operands' structure: for replicated a DistGroupedPlan where the
    dispatcher's cost model prefers the grouped kernel
    (``estimate_grouped_s < estimate_chunked_s``), else the chunked
    ChunkedPlan; for ring a RingPlan (hop default ``default_ring_hop``);
    for halo a HaloPlan."""
    if schedule not in ("replicated", "ring", "halo"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "ring" and ring_hop is None:
        ring_hop = default_ring_hop(n_shards)
    key = (a.rowptr, a.colidx, b.rowptr, b.colidx)
    extra = (n_shards, schedule, ring_hop if schedule == "ring" else None)
    plan = _PLAN_CACHE.get(key, extra)
    if plan is not None:
        return plan
    if schedule == "replicated":
        from ..ops.dispatch import estimate_chunked_s, estimate_grouped_s

        if estimate_grouped_s(a, b) < estimate_chunked_s(a, b):
            plan = make_dist_grouped_plan(a, b, n_shards)
        if plan is None:
            plan = make_dist_local_plan(a, b, n_shards)
    elif schedule == "ring":
        plan = make_ring_plan(a, b, n_shards, hop=ring_hop)
    else:
        from .halo import build_halo_plan

        plan = build_halo_plan(a, b, n_shards)
    return _PLAN_CACHE.put(key, extra, plan)


def dist_spgemm_local(a: CSR, b: CSR, mesh: Mesh, plan, schedule: str
                      ) -> CSR:
    """This rank's C rows under a plan from ``dist_plan`` (the numeric
    phase of ``dist_spgemm``: its exchange and its local kernel)."""
    n_sh = mesh.size
    if schedule == "replicated":
        a_sh = shard_rows_cached(a, n_sh)
        if isinstance(plan, DistGroupedPlan):
            return dist_spgemm_replicated(a_sh, b, mesh, grouped_plan=plan)
        return dist_spgemm_replicated(a_sh, b, mesh, plan=plan)
    if schedule == "ring":
        return dist_spgemm_ring(shard_rows_cached(a, n_sh),
                                shard_rows_cached(b, n_sh), mesh,
                                ring_plan=plan)
    from .halo import dist_spgemm_halo

    return dist_spgemm_halo(plan, shard_rows_cached(a, n_sh),
                            shard_rows_cached(b, n_sh), mesh)


def dist_spgemm(a: CSR, b: CSR, mesh: Mesh, *, schedule: str = "replicated",
                ring_hop: int | None = None) -> CSR:
    """Host-facing distributed C = A @ B, called on every rank with the
    whole A and B on the rank's device: plan, run this rank's rows, gather,
    unshard; every rank returns the whole C.

    schedule: 'replicated' (B on every rank), 'ring' (B row-sharded,
    blocks rotate) or 'halo' (B row-sharded, one ragged all-to-all).
    Sharded forms and plans are memoized per (matrix, P).

    ring_hop: blocks per resident ring super-buffer (default
    ``default_ring_hop``: P//4 at P >= 8, else 1)."""
    _on_mesh(mesh, a, "A")
    _on_mesh(mesh, b, "B")
    plan = dist_plan(a, b, mesh.size, schedule, ring_hop)
    c_loc = dist_spgemm_local(a, b, mesh, plan, schedule)
    return unshard(gather_shards(c_loc, mesh, (a.m, b.n)))
