"""Halo-exchange distributed SpGEMM: B row-sharded, the remote B rows each
rank needs (the halo of its A columns) fetched by one ragged all-to-all.

1. **Host halo plan** (``build_halo_plan``, once per structure): for each
   shard j, the sorted unique global B rows its A columns touch; for each
   (owner i, requester j) pair the slice i sends j. Every size and offset
   is a host (P, P) table, and each shard's A columns are remapped to
   halo-local rows, so the device work is a plain local SpGEMM against the
   assembled halo B.
2. **Exchange + compute** (``dist_spgemm_halo``, every rank): gather the
   rows to send from the local B block (``csr_gather_rows``), two
   ``Mesh.all_to_all_v`` calls (columns, then values) with the plan's
   split sizes, and the tuned chunked kernel against the halo. The slices
   arrive in source-rank order, which is the halo's global row order
   (owner-major), so the halo needs no scatter.

Per-rank B traffic is O(halo nnz), not O(nnz B) as under replication.
The reference's padded all-to-all emulation and its ``use_ragged`` switch
(XLA:CPU has no ragged all-to-all) are not carried, nor the capacities
only they and the reference's fixed-width fallback kernel read
(``chunk_cap``, ``prod_cap``, ``out_cap``): ``all_to_all_single`` is
ragged on every backend, and the local kernel is always the tuned
chunked plan.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.chunked import ChunkedPlan, spgemm_chunked
from ..sparse.csr import CSR, csr_gather_rows, host_view, pad_bucket
from .dist import (
    ShardedCSR,
    gather_shards,
    local_shard,
    make_dist_local_plan,
    shard_rows,
    unshard,
)
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host exchange plan for one (A, B, P) triple; tables on the CPU.
    Structure only: A's values come from its shards at each call, so one
    plan serves every A of this structure and partition."""

    a_colidx: torch.Tensor  # (P, cap) local A colidx remapped to halo rows
    send_rows: torch.Tensor  # (P, send_rows_cap) local B rows, dest-major, pad k_loc
    input_offsets: torch.Tensor  # (P, P) offsets into the send payload per dest
    send_sizes: torch.Tensor  # (P, P) [i, j]: nnz owner i sends requester j
    output_offsets: torch.Tensor  # (P, P) where i's slice lands in j's halo
    recv_sizes: torch.Tensor  # (P, P) [j, i]: nnz j receives from i
    recv_offsets: torch.Tensor  # (P, P) [j, i]: where i's slice lands in j's halo
    halo_rowptr: torch.Tensor  # (P, halo_rows_cap + 1) rowptr of the halo B
    send_payload_cap: int
    halo_nnz_cap: int
    shape_b: Tuple[int, int]
    # the tuned per-shard chunked plan (make_dist_local_plan, tables sized
    # on the halo)
    local_plan: ChunkedPlan
    bounds: tuple | None = None  # non-uniform A-row partition (if any)

    @property
    def n_shards(self) -> int:
        return self.a_colidx.shape[0]

    @property
    def halo_rows_cap(self) -> int:
        return self.halo_rowptr.shape[1] - 1


def build_halo_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None
) -> HaloPlan:
    """The halo plan, on the host (plan once, run many).

    bounds: product-balanced A-row boundaries (``dist.balanced_row_bounds``)
    for non-uniform row blocks."""
    m, k = a.shape
    n = b.n
    a_rowptr = host_view(a.rowptr)
    a_colidx = host_view(a.colidx)
    b_len = np.diff(host_view(b.rowptr))

    a_sh = shard_rows(a, n_shards, bounds=bounds)
    m_loc = a_sh.m_loc
    k_loc = -(-k // n_shards)

    # --- per-shard halo: sorted unique B rows touched by local A ----------
    # one global (shard, col) unique gives every shard's sorted halo; the
    # (owner, requester) tables fall out of bincounts and exclusive cumsums
    nnz_a = int(a_rowptr[-1])
    if bounds is None:
        rowptr_full = np.concatenate(
            [a_rowptr, np.full(n_shards * m_loc - m, a_rowptr[-1],
                               a_rowptr.dtype)]
        ).astype(np.int64)
        entry_shard = np.repeat(
            np.arange(n_shards * m_loc, dtype=np.int64) // m_loc,
            np.diff(rowptr_full),
        )
    else:
        row_of_shard = np.searchsorted(np.asarray(bounds, np.int64),
                                       np.arange(m), side="right") - 1
        entry_shard = np.repeat(
            row_of_shard, np.diff(a_rowptr.astype(np.int64)[: m + 1])
        )
    uk = np.unique(entry_shard * (k + 1) + a_colidx[:nnz_a].astype(np.int64))
    req = uk // (k + 1)  # requester shard of each unique halo row (sorted)
    hrow = uk % (k + 1)  # global B row (sorted within each requester)
    halo_starts = np.searchsorted(req, np.arange(n_shards + 1))
    halo_sizes = np.diff(halo_starts)
    hlen = b_len[hrow].astype(np.int64)  # nnz of each halo row
    halo_nnz = np.bincount(req, weights=hlen, minlength=n_shards).astype(
        np.int64)
    halo_rows_cap = pad_bucket(int(halo_sizes.max(initial=1)) or 1)
    halo_nnz_cap = pad_bucket(int(halo_nnz.max(initial=1)) or 1)

    # halo rowptr per shard (rows in global order): lengths scattered into
    # the padded (P, cap) grid, cumsum along rows
    within = np.arange(len(uk), dtype=np.int64) - halo_starts[req]
    lens_grid = np.zeros((n_shards, halo_rows_cap), np.int64)
    lens_grid[req, within] = hlen
    halo_rowptr = np.zeros((n_shards, halo_rows_cap + 1), np.int32)
    halo_rowptr[:, 1:] = np.cumsum(lens_grid, axis=1)

    # --- exchange tables: owner i -> requester j ---------------------------
    # j's halo is sorted by global row == owner-major, so the slice j needs
    # from owner i is contiguous in both j's halo and i's send buffer
    owner = hrow // k_loc
    szmat = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(szmat, (owner, req), hlen)
    input_offsets = (np.cumsum(szmat, axis=1) - szmat).astype(np.int32)
    output_offsets = (np.cumsum(szmat, axis=0) - szmat).astype(np.int32)

    # send row lists in (owner, requester, row) order
    order = np.lexsort((hrow, req, owner))
    o_s, h_s = owner[order], hrow[order]
    send_counts = np.bincount(owner, minlength=n_shards)
    send_starts = np.concatenate([[0], np.cumsum(send_counts)])
    send_within = np.arange(len(uk), dtype=np.int64) - send_starts[o_s]
    send_rows_cap = pad_bucket(int(send_counts.max(initial=1)) or 1)
    send_rows = np.full((n_shards, send_rows_cap), k_loc, np.int32)
    send_rows[o_s, send_within] = (h_s - o_s * k_loc).astype(np.int32)
    send_payload_cap = pad_bucket(
        int((input_offsets[:, -1] + szmat[:, -1]).max(initial=1)) or 1
    )

    # --- remap local A colidx -> halo-local row ----------------------------
    # uk is sorted, so a key's position within its shard's halo is its
    # global position minus the shard's halo start
    rp = a_sh.rowptr.numpy()
    ci = a_sh.colidx.numpy().astype(np.int64)
    lane = np.arange(ci.shape[1], dtype=np.int64)
    valid = lane[None, :] < rp[:, -1:].astype(np.int64)
    keys = np.where(
        valid, np.arange(n_shards, dtype=np.int64)[:, None] * (k + 1) + ci, 0
    )
    pos = np.searchsorted(uk, keys.reshape(-1)).reshape(keys.shape)
    local = pos - halo_starts[np.arange(n_shards)][:, None]
    ci = np.where(valid, local, ci).astype(np.int32)

    local_plan = make_dist_local_plan(
        a, b, n_shards,
        halo_lens=[hlen[halo_starts[j]:halo_starts[j + 1]]
                   for j in range(n_shards)],
        bounds=bounds,
    )
    return HaloPlan(
        local_plan=local_plan,
        a_colidx=torch.from_numpy(ci),
        bounds=a_sh.bounds,
        send_rows=torch.from_numpy(send_rows),
        input_offsets=torch.from_numpy(input_offsets),
        send_sizes=torch.from_numpy(szmat.astype(np.int32)),
        output_offsets=torch.from_numpy(output_offsets),
        recv_sizes=torch.from_numpy(szmat.T.astype(np.int32)),
        recv_offsets=torch.from_numpy(output_offsets.T.copy()),
        halo_rowptr=torch.from_numpy(halo_rowptr),
        send_payload_cap=send_payload_cap,
        halo_nnz_cap=halo_nnz_cap,
        shape_b=(k, n),
    )


def dist_spgemm_halo(plan: HaloPlan, a: ShardedCSR, b: ShardedCSR,
                     mesh: Mesh) -> CSR:
    """This rank's rows of C = A @ B: send the halo rows other ranks need
    from the local B block, receive this rank's halo, multiply this rank's
    A rows (``a``, in the plan's partition; the reference's plan carries
    A's values, this one pairs its remapped columns with ``a``'s)."""
    if mesh.size != plan.n_shards:
        raise ValueError(f"a {plan.n_shards}-shard plan on a "
                         f"{mesh.size}-rank mesh")
    if (a.n_shards, a.bounds, a.cap) != (plan.n_shards, plan.bounds,
                                         plan.a_colidx.shape[1]):
        raise ValueError("A's partition is not the halo plan's")
    r, dev = mesh.rank, mesh.device
    n = plan.shape_b[1]
    b_loc = local_shard(b, r, dev)
    payload = csr_gather_rows(b_loc, plan.send_rows[r].to(dev),
                              plan.send_payload_cap)
    send = plan.send_sizes[r].tolist()
    recv = plan.recv_sizes[r].tolist()
    got = sum(recv)
    halo_ci = torch.zeros(plan.halo_nnz_cap, dtype=torch.int32, device=dev)
    halo_va = torch.zeros(plan.halo_nnz_cap, dtype=payload.vals.dtype,
                          device=dev)
    halo_ci[:got] = mesh.all_to_all_v(payload.colidx, send, recv)
    halo_va[:got] = mesh.all_to_all_v(payload.vals, send, recv)
    a_loc = CSR(a.rowptr[r].to(dev), plan.a_colidx[r].to(dev),
                a.vals[r].to(dev), (a.m_loc, plan.halo_rows_cap))
    b_halo = CSR(plan.halo_rowptr[r].to(dev), halo_ci, halo_va,
                 (plan.halo_rows_cap, n))
    return spgemm_chunked(a_loc, b_halo, plan.local_plan)


def spgemm_halo(a: CSR, b: CSR, mesh: Mesh) -> CSR:
    """Host-facing halo-schedule C = A @ B on every rank: plan, shard B,
    run, gather, unshard."""
    plan = build_halo_plan(a, b, mesh.size)
    c_loc = dist_spgemm_halo(plan, shard_rows(a, mesh.size),
                             shard_rows(b, mesh.size), mesh)
    return unshard(gather_shards(c_loc, mesh, (a.m, b.n), plan.bounds))
