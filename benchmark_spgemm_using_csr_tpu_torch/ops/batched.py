"""Row-batched (out-of-core) SpGEMM for product streams too large for one
pass.

C's rows are computed in contiguous row blocks: each block is an
independent SpGEMM over a row slice of A (B untouched), so peak memory is
bounded by the largest block's working set.

- **Per-block method** among dense / grouped / chunked, from the same cost
  models as the in-core dispatcher (ops/dispatch), evaluated on the
  largest block.
- **Host planning once per structure** (cached on the structure buffers):
  C's exact structure is the concatenation of per-block pattern products,
  so the output rowptr/colidx live in the plan as device tensors and the
  value extraction positions of each block are static. The dense blocks'
  extraction payloads, the largest part of the plan, stay on the host
  (pinned for a CUDA device) and go up at their block's turn.
- **Per call**: the blocks run one after another (the reference's
  ``lax.scan`` over dense blocks becomes this loop); each block writes its
  exact values into C's value buffer, and its temporaries go before the
  next block starts.
- **as_scipy** (C larger than device memory): values fetched once after
  all blocks ran, structure from the host plan.

C keeps the reference's int32 CSR: a product whose nnz(C) passes 2^31 - 1
is refused by the plan (its row pointer would wrap).
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..sparse.csr import CSR, host_view, pad_bucket
from .chunked import make_chunked_plan, make_dist_local_plan, spgemm_chunked
from .dense import csr_to_dense, ieee_fp32
from .stream import pad_gentle, shift_compact
from .symbolic import total_products

log = logging.getLogger(__name__)

# the most entries an int32 row pointer can count
INT32_MAX = 2**31 - 1


def row_products(a_sp, b_rowptr) -> np.ndarray:
    """Each row's count of intermediate products of A @ B (int64), from
    A's host structure and B's row pointer."""
    b_len = np.diff(b_rowptr).astype(np.int64)
    out = np.zeros(a_sp.shape[0], np.int64)
    if a_sp.nnz:
        cs = np.concatenate([[0], np.cumsum(b_len[a_sp.indices])])
        out = cs[a_sp.indptr[1:]] - cs[a_sp.indptr[:-1]]
    return out


def plan_row_batches(
    nnz_ct: np.ndarray, stream_budget: int
) -> list[tuple[int, int]]:
    """Greedy contiguous row blocks with <= stream_budget products each (a
    single oversized row becomes a block of its own): one searchsorted per
    block over the prefix sums."""
    m = len(nnz_ct)
    if m == 0:
        return [(0, 0)]
    cum = np.concatenate([[0], np.cumsum(nnz_ct, dtype=np.int64)])
    blocks = []
    start = 0
    while start < m:
        end = int(np.searchsorted(cum, cum[start] + stream_budget,
                                  side="right")) - 1
        end = min(max(end, start + 1), m)
        blocks.append((start, end))
        start = end
    return blocks


@dataclasses.dataclass
class BatchedPlan:
    """Built on the host once per (A structure, B structure) pair; its
    tensors live on A's device, so repeat calls upload nothing."""

    method: str  # 'dense' | 'grouped' | 'chunked'
    blocks: tuple  # ((lo, hi), ...) contiguous row spans
    rows_cap: int  # unified padded rows per block
    nnz_cap: int  # unified padded A entries per block
    slice0: tuple  # per-block start into A.vals
    nnz_blk: tuple  # per-block exact A nnz
    nnz_c_blk: tuple  # per-block exact nnz(C) (assembly offsets)
    nnz_c: int
    out_rowptr: torch.Tensor  # (m + 1,) C's rowptr
    out_colidx: torch.Tensor  # (cap_c,) C's colidx
    cap_c: int
    host_rowptr: np.ndarray  # host copies for as_scipy
    host_colidx: np.ndarray
    blk_rowptr: tuple  # per-block (rows_cap + 1,) rowptr
    blk_colidx: tuple  # per-block (nnz_cap,) colidx
    blk_rows_e: tuple  # per-block (nnz_cap,) entry row ids (pad: rows_cap)
    # dense method: per-block ('full' | 'shift' | 'gather', payload), the
    # payload host tensors uploaded at the block's turn
    flat_c: tuple = ()
    cap_c_u: int = 0  # unified per-block C capacity
    # grouped method: per-block GroupedSchedule under unified statics
    grouped_scheds: tuple = ()
    # chunked method: one plan for every block
    chunked_plan: object = None
    # the grouped regime rejected a block and the blocks run chunked
    fell_back: bool = False
    # make_batched_plan's host seconds by stage: 'pick' (row blocks, the
    # method's pick, the block slices), 'patterns' (C's structure),
    # 'upload' (the plan's device tensors), 'schedules' (the method's
    # per-block plans)
    stage_s: dict = dataclasses.field(default_factory=dict)


def _block_slices(a_sp, blocks, rows_cap, nnz_cap):
    """Per-block padded structure (host): rowptr, colidx, entry row ids."""
    rowptrs, colidxs, rows_es, slice0, nnz_blk = [], [], [], [], []
    for lo, hi in blocks:
        s0, s1 = int(a_sp.indptr[lo]), int(a_sp.indptr[hi])
        nb = s1 - s0
        rp = np.full(rows_cap + 1, nb, np.int32)
        rp[: hi - lo + 1] = a_sp.indptr[lo:hi + 1] - s0
        ci = np.zeros(nnz_cap, np.int32)
        ci[:nb] = a_sp.indices[s0:s1]
        re = np.full(nnz_cap, rows_cap, np.int32)
        re[:nb] = (np.repeat(np.arange(lo, hi), np.diff(a_sp.indptr[lo:hi + 1]))
                   - lo)
        rowptrs.append(rp)
        colidxs.append(ci)
        rows_es.append(re)
        slice0.append(s0)
        nnz_blk.append(nb)
    return rowptrs, colidxs, rows_es, slice0, nnz_blk


def make_batched_plan(
    a: CSR,
    b: CSR,
    stream_budget: int = 64 * 1024 * 1024,
    dense_block_bytes: int = 128 << 20,
    method: str | None = None,
) -> BatchedPlan:
    """Host stage 2 of the out-of-core path (plan once, run many). Raises
    ValueError when nnz(C) passes INT32_MAX."""
    import scipy.sparse as sp

    marks, stage_s = [time.perf_counter()], {}

    def lap(stage):  # the host seconds since the last stage ended
        marks.append(time.perf_counter())
        stage_s[stage] = marks[-1] - marks[-2]

    m, n = a.m, b.n
    dev = a.device
    nnz_a = int(host_view(a.rowptr)[-1])
    a_sp = sp.csr_matrix(
        (host_view(a.vals)[:nnz_a], host_view(a.colidx)[:nnz_a],
         host_view(a.rowptr)[: m + 1]),
        shape=(m, a.n),
    )
    b_rowptr = host_view(b.rowptr)
    blocks = plan_row_batches(row_products(a_sp, b_rowptr), stream_budget)

    # method: the in-core cost models on the largest block (blocks are
    # product-balanced, so it is representative)
    if method is None:
        from . import dispatch as D

        lo, hi = max(blocks, key=lambda be: be[1] - be[0])
        # the estimators read host copies only: the block stays on the host
        sub = CSR.from_scipy(sp.csr_matrix(a_sp[lo:hi]), device="cpu")
        est = {
            "chunked": D.estimate_chunked_s(sub, b),
            "grouped": D.estimate_grouped_s(sub, b),
            "dense": D.estimate_dense_s(sub, b),
        }
        method = min(est, key=est.get)
        log.info("batched method=%s est=%s", method, est)

    if method == "dense":
        # memory-bound blocking: a block's dense C is rows * n * itemsize
        itemsize = a.vals.element_size()
        rows_blk = int(max(min(dense_block_bytes // (n * itemsize), m), 8))
        blocks = [(lo, min(lo + rows_blk, m)) for lo in range(0, m, rows_blk)]

    rows_cap = pad_bucket(max(hi - lo for lo, hi in blocks))
    nnz_cap = pad_bucket(
        max(int(a_sp.indptr[hi] - a_sp.indptr[lo]) for lo, hi in blocks) or 1
    )
    rowptrs, colidxs, rows_es, slice0, nnz_blk = _block_slices(
        a_sp, blocks, rows_cap, nnz_cap
    )

    lap("pick")
    # exact per-block C pattern (assembly offsets + output structure)
    pat_a = sp.csr_matrix(
        (np.ones(a_sp.nnz, np.bool_), a_sp.indices, a_sp.indptr),
        shape=a_sp.shape,
    )
    b_ci = host_view(b.colidx)[: int(b_rowptr[-1])]
    pat_b = sp.csr_matrix(
        (np.ones(len(b_ci), np.bool_), b_ci, b_rowptr[: b.m + 1]),
        shape=(b.m, n),
    )
    pats, nnz_c = [], 0
    for lo, hi in blocks:
        indptr, indices = _block_pattern(pat_a, pat_b, lo, hi)
        nnz_c += int(indptr[-1])
        if nnz_c > INT32_MAX:
            raise ValueError(
                f"nnz(C) reaches {nnz_c:,} by row {hi} of {m}, past the "
                f"int32 CSR's 2^31 - 1 = {INT32_MAX:,}: C's row pointer "
                "would wrap")
        pats.append((indptr, indices))
    nnz_c_blk = tuple(int(ip[-1]) for ip, _ in pats)
    cap_c = pad_bucket(max(nnz_c, 1))
    out_rowptr = np.zeros(m + 1, np.int64)
    out_colidx = np.zeros(cap_c, np.int32)
    off = 0
    for i, (lo, hi) in enumerate(blocks):
        indptr, indices = pats[i]
        out_rowptr[lo + 1:hi + 1] = off + indptr[1:]
        out_colidx[off:off + len(indices)] = indices
        off += len(indices)
        if method != "dense":  # only the dense extraction reads it again
            pats[i] = None

    lap("patterns")

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def on_host(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if torch.device(dev).type == "cuda" else t

    plan = BatchedPlan(
        method=method,
        blocks=tuple(blocks),
        rows_cap=rows_cap,
        nnz_cap=nnz_cap,
        slice0=tuple(slice0),
        nnz_blk=tuple(nnz_blk),
        nnz_c_blk=nnz_c_blk,
        nnz_c=nnz_c,
        out_rowptr=on_dev(out_rowptr.astype(np.int32)),
        out_colidx=on_dev(out_colidx),
        cap_c=cap_c,
        host_rowptr=out_rowptr,
        host_colidx=out_colidx,
        blk_rowptr=tuple(on_dev(r) for r in rowptrs),
        blk_colidx=tuple(on_dev(c) for c in colidxs),
        blk_rows_e=tuple(on_dev(r) for r in rows_es),
    )

    lap("upload")
    if method == "dense":
        # per-block extraction: 'full' (C block structurally dense),
        # 'shift' (near-dense: kept/disp and a stable left-compaction),
        # 'gather' (sparser C: nnz_c flat-position gathers)
        cap_c_u = pad_bucket(max(max(nnz_c_blk), 1))
        slots = rows_cap * n
        extract = []
        for (lo, hi), (indptr, indices) in zip(blocks, pats):
            rr = np.repeat(np.arange(hi - lo, dtype=np.int64),
                           np.diff(indptr))
            flat = rr * n + indices.astype(np.int64)
            holes = slots - len(indices)
            if holes == 0:
                extract.append(("full", None))
            elif holes < slots // 8:
                kept = np.zeros(slots, np.bool_)
                kept[flat] = True
                disp = (np.cumsum(~kept) - ~kept).astype(np.int32)
                extract.append(("shift", (on_host(kept), on_host(disp))))
            else:
                f = np.full(cap_c_u, slots, np.int64)  # pad -> guard slot
                f[: len(indices)] = flat
                extract.append(("gather", on_host(f)))
        plan.flat_c = tuple(extract)
        plan.cap_c_u = cap_c_u
    elif method == "grouped":
        plan.grouped_scheds = _grouped_block_scheds(plan, a, b, rowptrs,
                                                    colidxs)
        if plan.grouped_scheds is None:
            # the blocks and C's structure do not depend on the method
            # (only dense cuts its own blocks): run them chunked
            log.info("grouped regime rejected a block; falling back chunked")
            method = plan.method = "chunked"
            plan.grouped_scheds = ()
            plan.fell_back = True
    if method == "chunked":
        plan.chunked_plan = make_dist_local_plan(
            a, b, n_shards=len(blocks),
            bounds=np.asarray([lo for lo, _ in blocks] + [m], np.int64),
        )
    lap("schedules")
    plan.stage_s = stage_s
    return plan


def _block_pattern(pat_a, pat_b, lo: int, hi: int):
    """Rows [lo, hi) of C's pattern as (indptr, indices), columns sorted.
    The patterns are boolean: scipy sums them by logical or, so no count
    can wrap or cancel to 0, at a byte an entry."""
    pc = (pat_a[lo:hi] @ pat_b).tocsr()
    pc.sort_indices()
    return pc.indptr, pc.indices


def _grouped_block_scheds(plan, a, b, rowptrs, colidxs):
    """Per-block grouped schedules under one set of statics: plan every
    block, take the max of each capacity, rebuild every block under it.
    Each block's nnz(C) is the plan's own count (its pattern)."""
    from .grouped import make_grouped_plan

    subs = []
    for rp, ci in zip(rowptrs, colidxs):
        # structure only: the schedules read no value
        va = np.ones(plan.nnz_cap, host_view(a.vals).dtype)
        subs.append(CSR.from_numpy(rp, ci, va, (plan.rows_cap, a.n),
                                   device=a.device))
    base = make_grouped_plan(subs[0], b, nnz_c=plan.nnz_c_blk[0])
    if base is None:
        return None
    bp = base.plan
    p1 = [
        make_grouped_plan(
            s, b, al=bp.al, target_slots=bp.cs * bp.lanes,
            force_scatter_set=bp.scatter_set, nnz_c=nnz_c,
        )
        for s, nnz_c in zip(subs, plan.nnz_c_blk)
    ]
    if any(p is None for p in p1):
        return None
    live = [p.plan for p in p1]
    cs_u = max(p.cs for p in live)
    g_u = max(p.g_cap for p in live)
    nnz_max = max(p.nnz_c for p in live)
    unified = dataclasses.replace(
        bp,
        cs=cs_u,
        g_cap=g_u,
        out_cap=min(pad_gentle(max(nnz_max, 1)), g_u * cs_u * bp.lanes),
        nnz_c=nnz_max,
        max_run=max(p.max_run for p in live),
        lbits=max(p.lbits for p in live),
    )
    return tuple(make_grouped_plan(s, b, fixed=unified) for s in subs)


def _held_key(a: CSR, b: CSR):
    """A cache key on the structure buffers, and the buffers it names: a
    cache holds them, since ids recycle after garbage collection and a
    stale hit would return another matrix's entry."""
    bufs = (a.rowptr, a.colidx, b.rowptr, b.colidx)
    return tuple(id(x) for x in bufs), bufs


_plan_cache: dict = {}


def _cached_plan(a: CSR, b: CSR, stream_budget, method) -> BatchedPlan:
    ids, bufs = _held_key(a, b)
    key = ids + (stream_budget, method)
    hit = _plan_cache.get(key)
    if hit is not None:
        return hit[0]
    plan = make_batched_plan(a, b, stream_budget=stream_budget, method=method)
    _plan_cache.clear()  # bound memory: these plans hold device tensors
    _plan_cache[key] = (plan, bufs)
    return plan


_total_cache: dict = {}


def _cached_total(a: CSR, b: CSR) -> int:
    """The intermediate-product total, memoized on the structure buffers
    (one device -> host read per structure)."""
    key, bufs = _held_key(a, b)
    hit = _total_cache.get(key)
    if hit is not None:
        return hit[0]
    total = int(total_products(a, b))
    if len(_total_cache) >= 8:
        _total_cache.pop(next(iter(_total_cache)))
    _total_cache[key] = (total, bufs)
    return total


def _dense_block(vals_pad, s0, rows_e, cols_e, db, mode, payload, *,
                 rows_cap, nnz_cap, kdim):
    """One dense block: densify the A row slice (padding entries target a
    guard row), matmul against the dense B, extract C's values at the
    block's static structural positions (the payload is uploaded here)."""
    v = vals_pad[s0: s0 + nnz_cap]
    da = torch.zeros((rows_cap + 1, kdim), dtype=v.dtype, device=v.device)
    da[rows_e.long(), cols_e.long()] = v
    with ieee_fp32():
        flat = (da[:rows_cap] @ db).reshape(-1)
    del da
    if mode == "full":  # block C structurally full
        return flat
    if mode == "shift":
        kept, disp = (x.to(flat.device, non_blocking=True) for x in payload)
        return shift_compact(kept, disp, [flat])[0]
    pos = payload.to(flat.device, non_blocking=True)
    guard = torch.cat([flat, flat.new_zeros(1)])
    return guard[torch.clamp(pos, 0, flat.shape[0])]


def spgemm_batched(
    a: CSR,
    b: CSR,
    stream_budget: int = 64 * 1024 * 1024,
    k: int | None = None,  # kept for API compatibility; unused
    as_scipy: bool | None = None,
    method: str | None = None,
) -> "CSR | object":
    """C = A @ B with bounded peak memory (module docstring).

    as_scipy: return a host scipy CSR instead of a device CSR. None = auto:
    a host result whenever the assembled C exceeds 2 GiB."""
    del k
    m, n = a.m, b.n
    if _cached_total(a, b) <= stream_budget:
        return spgemm_chunked(a, b, make_chunked_plan(a, b))

    plan = _cached_plan(a, b, stream_budget, method)
    if as_scipy is None:
        as_scipy = plan.nnz_c * (4 + a.vals.element_size()) > (2 << 30)

    # block values: slices of A's values, padded so the last block's slice
    # stays in bounds
    vals_pad = torch.cat([a.vals, a.vals.new_zeros(plan.nnz_cap)])
    vals = torch.zeros(plan.cap_c, dtype=a.vals.dtype, device=a.device)
    if plan.method == "dense":
        db = csr_to_dense(b)
    else:
        from .grouped import spgemm_grouped
    off = 0
    for i, nnz_blk in enumerate(plan.nnz_c_blk):
        s0 = plan.slice0[i]
        if plan.method == "dense":
            mode, payload = plan.flat_c[i]
            blk = _dense_block(
                vals_pad, s0, plan.blk_rows_e[i], plan.blk_colidx[i], db,
                mode, payload, rows_cap=plan.rows_cap, nnz_cap=plan.nnz_cap,
                kdim=a.n,
            )
        else:
            a_blk = CSR(plan.blk_rowptr[i], plan.blk_colidx[i],
                        vals_pad[s0: s0 + plan.nnz_cap], (plan.rows_cap, a.n))
            if plan.method == "grouped":
                blk = spgemm_grouped(a_blk, b, plan.grouped_scheds[i]).vals
            else:
                blk = spgemm_chunked(a_blk, b, plan.chunked_plan).vals
        # only the block's exact values outlive it
        vals[off: off + nnz_blk] = blk[:nnz_blk]
        off += nnz_blk
        del blk
    if as_scipy:
        import scipy.sparse as sp

        return sp.csr_matrix(
            (vals[: plan.nnz_c].cpu().numpy(),
             plan.host_colidx[: plan.nnz_c].copy(),
             plan.host_rowptr.astype(np.int64)),
            shape=(m, n),
        )
    return CSR(rowptr=plan.out_rowptr, colidx=plan.out_colidx, vals=vals,
               shape=(m, n))
