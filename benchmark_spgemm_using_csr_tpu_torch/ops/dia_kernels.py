"""Kernel K3, the fused multi-plane DIA product, with its plain PyTorch
version.

``dia_spgemm_fused`` replaces the reference package's Pallas kernel
``ops/dia_pallas.py::dia_spgemm_fused``: C = A @ B on diagonal planes,
``C[dc][j] = sum_{d1 + d2 = dc} A[d1][j - d2] * B[d2][j]``, with output
offsets ``sorted{d1 + d2}``. The CUDA source is
``csrc/dia_spgemm_fused.cu``, built with nvcc for sm_90a at first use and
called through ctypes on PyTorch's current stream; its host half, the
launch plan (``launch_plan``: which rows each block stages in shared memory
and where each term reads them), is built once per offset pair and shape.
Each output plane's sum adds its terms in ascending B slot, without
contracting into an FMA, so the kernel equals its plain version, the gather
form that ``ops/dia.dia_spgemm`` runs off the kernel, bit for bit.

Dispatch is by the device of the planes: CPU tensors run the plain
version, CUDA tensors run the kernel or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..sparse.dia import DIA
from . import _build

# the C entry point's arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K3_ARGS = (_P,) * 7 + (_I, _LL, _I, _LL, _LL, _I, _I, _I, _I, _I)


def plan_terms(off_a, off_b):
    """Static term table: the output offsets ``sorted{d1 + d2}`` and, per
    output offset dc, the (slot_a, slot_b, d2) triples with d1 + d2 == dc,
    in ascending slot_b."""
    a_slot = {d: s for s, d in enumerate(off_a)}
    off_c = sorted({d1 + d2 for d1 in off_a for d2 in off_b})
    terms = {dc: [] for dc in off_c}
    for s2, d2 in enumerate(off_b):
        for d1 in off_a:
            terms[d1 + d2].append((a_slot[d1], s2, d2))
    return off_c, terms


@functools.lru_cache(maxsize=64)
def _term_plan(off_a: tuple, off_b: tuple):
    """``plan_terms`` once per offset pair: (off_c, terms, span), with
    span the shift span of B's offsets (0 when B has none)."""
    off_c, terms = plan_terms(off_a, off_b)
    span = max(0, max(off_b, default=0)) + max(0, -min(off_b, default=0))
    return tuple(off_c), terms, span


def _prepare(a: DIA, b: DIA, bj: int):
    """The reference contract before any arithmetic: inner dimensions, the
    output type and offsets, and the shift span against ``bj``. Returns
    (out_dtype, off_c), or None for an empty operand."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"planes on {a.device} and {b.device}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"need float32 or float64 planes, got {a.dtype} / "
                        f"{b.dtype}")
    off_c, _, span = _term_plan(tuple(a.offsets), tuple(b.offsets))
    if not off_c:
        return None
    if span > bj:
        raise ValueError(f"shift span {span} exceeds block {bj}")
    return out_dtype, off_c


def _zero(a: DIA, b: DIA) -> DIA:
    """The product of an operand with no stored diagonal: one zero plane at
    offset 0."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return DIA(torch.zeros((1, b.n), dtype=dtype, device=a.device), (0,),
               (a.m, b.n))


def gather_form(a: DIA, b: DIA) -> DIA:
    """The product in torch ops, as the reference leaves it to XLA: each
    output plane the sum of its shifted terms ``A[d1, j - d2] * B[d2, j]``,
    started from the first term and added in ascending B slot. Reads off
    A's planes are zeros (A is padded)."""
    off_c, terms, _ = _term_plan(tuple(a.offsets), tuple(b.offsets))
    if not off_c:  # either operand all-zero (no stored diagonals)
        return _zero(a, b)
    k, n = a.n, b.n
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    pad_l = max(0, max(b.offsets))
    pad_r = max(0, n - k - min(b.offsets))
    a_pad = torch.nn.functional.pad(a.data.to(out_dtype), (pad_l, pad_r))
    b_data = b.data.to(out_dtype)
    planes = []
    for dc in off_c:
        acc = None
        for s1, s2, d2 in terms[dc]:
            start = pad_l - d2
            prod = a_pad[s1, start:start + n] * b_data[s2]
            acc = prod if acc is None else acc + prod
        planes.append(acc)
    return DIA(torch.stack(planes), tuple(off_c), (a.m, n))


def dia_spgemm_fused_plain(a: DIA, b: DIA, bj: int = 4096) -> DIA:
    """Plain PyTorch version of K3: the gather form, under K3's contract
    (types, devices and the shift span against ``bj``). Each plane's terms
    are added in the order K3 adds them, so the two agree bit for bit."""
    if _prepare(a, b, bj) is None:
        return _zero(a, b)
    return gather_form(a, b)


# The launch plan's limits, from the H100 (132 SMs; a block may use up to
# 227 KB of shared memory) and csrc/dia_spgemm_fused.cu (8 or 16 warps a
# block).
SMS = 132
CLUSTER_GAP = 16  # B offsets further apart than this start a new cluster
CLUSTER_WIDTH = 64  # and a cluster spans at most this many columns
TILES = (256, 128, 64, 32)  # columns per tile, widest first
SMEM_BUDGET = 112 * 1024  # shared memory per block: two blocks on one SM
SMEM_MAX = 232448  # the most one block may ask for
TARGET_BLOCKS = 4 * SMS  # (plane group, tile) pairs enough to fill the SMs
DIRECT_TILE = 1024  # columns per direct block: 32 * 4 slots for each of 8 warps
PLANES_PER_ITEM = 3  # planes a warp sums at once, sharing B's loads


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What K3 needs from the offsets and the shape, as host int32 arrays
    (built by ``launch_plan``).

    A block computes one group of consecutive output planes on one tile of
    ``tile`` columns. Staged, a warp adds the terms
    of an item (PLANES_PER_ITEM consecutive planes of the group) on 32 *
    ``lanes`` columns: one entry per B row the item's planes read, in
    ascending B slot, with the A window of each plane that has a term
    there; direct, a warp adds one plane's terms.

    groups:      (G, 8) per group: first plane, planes, first row, B rows,
                 A rows, first entry, entries, byte offset of the entries
                 in shared memory (after the staged rows; the group's
                 items follow them there);
    rows:        (R, 4) per staged row: plane slot, shift (the window
                 starts at column j0 - shift), width, element offset in
                 the row buffer, the last three multiples of 16 bytes; a
                 group's B rows, then its A rows;
    plane_terms: (nd_c, 4) staged: a group's items, in its first rows,
                 heaviest first: first plane (from the group's), planes,
                 entries [start, end) counted from the group's first;
                 direct: (0, 1, start, end) each plane's terms;
    terms:       staged (E, 4) entries: byte offsets in the row buffer of
                 the B row and of the A window, at the term's shift, of
                 each of the item's planes (-1: no term);
                 direct (T, 4): (s1, s2, d2, 0).
    """

    staged: bool
    tile: int
    lanes: int
    warps: int
    ntiles: int
    smem: int
    groups: np.ndarray
    rows: np.ndarray
    plane_terms: np.ndarray
    terms: np.ndarray


def b_clusters(off_b) -> list:
    """B's sorted offsets cut into clusters of near offsets, as slot ranges
    [lo, hi): a cluster ends where the next offset lies more than
    CLUSTER_GAP past the last or more than CLUSTER_WIDTH past the first.
    The A columns a tile's terms of one cluster read form one narrow
    window per A plane."""
    out, lo = [], 0
    for s in range(1, len(off_b) + 1):
        if (s == len(off_b) or off_b[s] - off_b[s - 1] > CLUSTER_GAP
                or off_b[s] - off_b[lo] > CLUSTER_WIDTH):
            out.append((lo, s))
            lo = s
    return out


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _group_planes(planes, cluster, width, tile, itemsize, limit, term_cap):
    """Consecutive output planes packed into groups of at most ``term_cap``
    terms (past it only to hold one plane) whose shared memory fits
    ``limit`` bytes: the staged rows, the entry table and the item
    list. None when one plane alone does not fit.
    ``width[c]`` is the staged width of cluster c's A windows. Each group
    is (first plane, planes, B slots, A rows as (cluster, A slot))."""
    def footprint(b_rows, a_rows, nentries, nplanes):
        cols = len(b_rows) * tile + sum(width[c] for c, _ in a_rows)
        return (_align16(cols * itemsize) + 16 * nentries
                + 16 * -(-nplanes // PLANES_PER_ITEM))

    groups = []
    for p, plane in enumerate(planes):
        b_rows = {s2 for _, s2, _ in plane}
        a_rows = {(cluster[s2], s1) for s1, s2, _ in plane}
        if footprint(b_rows, a_rows, len(b_rows), 1) > limit:
            return None
        if groups:
            p0, count, b_grp, a_grp, nterms, entries, last = groups[-1]
            b_new, a_new = b_grp | b_rows, a_grp | a_rows
            if count % PLANES_PER_ITEM:  # p joins the group's last item
                joined = last | b_rows
                e_new = entries - len(last) + len(joined)
            else:
                joined, e_new = b_rows, entries + len(b_rows)
            if (nterms + len(plane) <= term_cap and footprint(
                    b_new, a_new, e_new, count + 1) <= limit):
                groups[-1] = (p0, count + 1, b_new, a_new,
                              nterms + len(plane), e_new, joined)
                continue
        groups.append((p, 1, b_rows, a_rows, len(plane), len(b_rows),
                       b_rows))
    return [g[:4] for g in groups]


@functools.lru_cache(maxsize=64)
def launch_plan(off_a: tuple, off_b: tuple, n: int, itemsize: int
                ) -> LaunchPlan:
    """K3's launch plan for planes of ``itemsize`` bytes, built once per
    offset pair and shape (the host half of the kernel).

    B's offsets are cut into clusters (``b_clusters``). A term (s1, s2, d2)
    of a block whose tile starts at column j0 reads A[s1] at j - d2 for j
    in the tile: with s2 in cluster c (offsets up to d2max_c, width w_c),
    that is column j - j0 + d2max_c - d2 of the window A[s1][j0 - d2max_c,
    j0 + tile + w_c), staged once for every term of the group that reads
    A[s1] through cluster c. The widest tile of TILES at which every plane
    alone fits SMEM_BUDGET bytes (two blocks per SM), and that still gives
    TARGET_BLOCKS, is taken, else the narrowest that fits; then planes are
    packed into groups of about equal term counts (``_group_planes``),
    enough of them that the blocks reach TARGET_BLOCKS. Where no tile fits
    even SMEM_MAX, the plan is the direct mode: one plane per group, A and
    B read from global memory."""
    return _plan(off_a, off_b, n, itemsize, TILES, SMEM_BUDGET)


def _plan(off_a: tuple, off_b: tuple, n: int, itemsize: int, tiles: tuple,
          budget: int) -> LaunchPlan:
    """``launch_plan`` choosing its tile among ``tiles`` (a subset of
    TILES) under a shared-memory ``budget``."""
    if not set(tiles) <= set(TILES):
        raise ValueError(f"tiles {tiles} not among {TILES}")
    off_c, by_dc, _ = _term_plan(off_a, off_b)
    planes = [by_dc[dc] for dc in off_c]
    clusters = b_clusters(off_b)
    cluster = [c for c, (lo, hi) in enumerate(clusters) for _ in range(lo, hi)]
    # windows start on a 16-byte boundary (the kernel's 16-byte copies):
    # the shift rounds up to a multiple of e elements, the width too
    e = 16 // itemsize
    shift = [-(-off_b[hi - 1] // e) * e for lo, hi in clusters]
    extra = [s - off_b[lo] for s, (lo, hi) in zip(shift, clusters)]

    def widths(t):
        return [-(-(t + x) // e) * e for x in extra]

    for limit in (budget, SMEM_MAX):
        fits = [t for t in tiles
                if _group_planes(planes, cluster, widths(t), t, itemsize,
                                 limit, 1) is not None]
        if not fits:
            continue
        tj = next((t for t in fits if -(-n // t) * len(planes)
                   >= TARGET_BLOCKS), fits[-1])
        ntiles = -(-n // tj)
        total = sum(len(plane) for plane in planes)
        cap = -(-total // -(-TARGET_BLOCKS // ntiles))
        groups = _group_planes(planes, cluster, widths(tj), tj, itemsize,
                               limit, cap)
        return _staged_plan(planes, groups, cluster, shift, widths(tj), tj,
                            ntiles, itemsize)
    return _direct_plan(planes, n)


def _staged_plan(planes, groups, cluster, shift, width, tile, ntiles,
                 itemsize) -> LaunchPlan:
    """The staged mode's arrays (see ``LaunchPlan``) for ``groups``; A rows
    of cluster c start ``shift[c]`` columns left of the tile and are
    ``width[c]`` wide."""
    group_rows, rows, terms = [], [], []
    plane_terms = np.zeros((len(planes), 4), np.int32)
    smem = 0
    for p0, count, b_rows, a_rows in groups:
        row0 = len(rows)
        b_at = {}
        for i, s2 in enumerate(sorted(b_rows)):
            b_at[s2] = i * tile
            rows.append((s2, 0, tile, i * tile))
        at = len(b_rows) * tile
        a_at = {}
        for c, s1 in sorted(a_rows):
            a_at[c, s1] = at
            rows.append((s1, shift[c], width[c], at))
            at += width[c]
        terms_at = _align16(at * itemsize)
        term0 = len(terms)
        items = []
        for i in range(p0, p0 + count, PLANES_PER_ITEM):
            item = range(i, min(i + PLANES_PER_ITEM, p0 + count))
            a_of = [{s2: (s1, d2) for s1, s2, d2 in planes[p]} for p in item]
            start = len(terms) - term0
            for s2 in sorted(set().union(*a_of)):
                c = cluster[s2]
                entry = [itemsize * b_at[s2]] + [-1] * PLANES_PER_ITEM
                for q, terms_of in enumerate(a_of):
                    if s2 in terms_of:
                        s1, d2 = terms_of[s2]
                        entry[1 + q] = itemsize * (a_at[c, s1] + shift[c] - d2)
                terms.append(entry)
            items.append((i - p0, len(item), start, len(terms) - term0))
        # heaviest item first: the warps take them in turn
        items.sort(key=lambda it: it[2] - it[3])
        plane_terms[p0:p0 + len(items)] = items
        nterms = len(terms) - term0
        group_rows.append((p0, count, row0, len(b_rows), len(a_rows), term0,
                           nterms, terms_at))
        smem = max(smem, terms_at + 16 * nterms + 16 * len(items))
    # warps a block (8 or 16) and slots a lane (1, 2 or 4): as many as
    # leave every warp of the largest group an item on the tile
    items = -(-max(count for _, count, _, _ in groups) // PLANES_PER_ITEM)
    lanes = min(4, tile // 32)
    warps = 16 if items * tile // (32 * lanes) >= 16 else 8
    while lanes > 1 and items * tile // (32 * lanes) < warps:
        lanes //= 2
    return LaunchPlan(
        staged=True, tile=tile, lanes=lanes, warps=warps, ntiles=ntiles,
        smem=smem, groups=np.asarray(group_rows, np.int32).reshape(-1, 8),
        rows=np.asarray(rows, np.int32).reshape(-1, 4),
        plane_terms=plane_terms,
        terms=np.asarray(terms, np.int32).reshape(-1, 4))


def _direct_plan(planes, n: int) -> LaunchPlan:
    """The direct mode's arrays: one plane per group, terms (s1, s2, d2)."""
    counts = [len(plane) for plane in planes]
    ends = np.cumsum(counts)
    plane_terms = np.stack([np.zeros_like(ends), np.ones_like(ends),
                            ends - counts, ends], axis=1).astype(np.int32)
    terms = [(s1, s2, d2, 0) for plane in planes for s1, s2, d2 in plane]
    groups = [(p, 1, 0, 0, 0, 0, 0, 0) for p in range(len(planes))]
    return LaunchPlan(
        staged=False, tile=DIRECT_TILE, lanes=4, warps=8,
        ntiles=-(-n // DIRECT_TILE), smem=0,
        groups=np.asarray(groups, np.int32).reshape(-1, 8),
        rows=np.zeros((0, 4), np.int32), plane_terms=plane_terms,
        terms=np.asarray(terms, np.int32).reshape(-1, 4))


@functools.lru_cache(maxsize=64)
def _device_plan(off_a: tuple, off_b: tuple, n: int, itemsize: int,
                 device: torch.device):
    """``launch_plan`` with its arrays on ``device``, once per key."""
    plan = launch_plan(off_a, off_b, n, itemsize)
    tables = tuple(torch.from_numpy(x).to(device) for x in (
        plan.groups, plan.rows, plan.plane_terms, plan.terms))
    return plan, tables


def dia_spgemm_fused(a: DIA, b: DIA, bj: int = 4096) -> DIA:
    """C = A @ B on diagonal planes with one kernel launch (K3).

    Keeps the reference contract: float32 or float64 planes (the output
    takes the promoted type), a ``ValueError`` when the shift span of B's
    offsets exceeds ``bj``, and one zero plane at offset 0 when an operand
    has no diagonal. The CUDA kernel reads A in bounds and needs no block
    of ``bj`` columns itself; the span limit stays so that callers and
    errors agree with the reference. CPU planes run
    ``dia_spgemm_fused_plain``."""
    prep = _prepare(a, b, bj)
    if prep is None:
        return _zero(a, b)
    if a.device.type == "cpu":
        return dia_spgemm_fused_plain(a, b, bj)
    if a.device.type != "cuda":
        raise ValueError(f"no dia_spgemm_fused for device {a.device}")
    out_dtype, off_c = prep
    a_data = a.data.to(out_dtype)
    b_data = b.data.to(out_dtype)
    if a_data.shape != (a.ndiag, a.n) or b_data.shape != (b.ndiag, b.n):
        raise ValueError(f"planes {tuple(a_data.shape)} / "
                         f"{tuple(b_data.shape)} do not match the offsets "
                         "and shapes")
    if not (a_data.is_contiguous() and b_data.is_contiguous()):
        raise ValueError("dia_spgemm_fused needs contiguous planes")
    k, n = a.n, b.n
    itemsize = a_data.element_size()
    plan, (groups, rows, plane_terms, terms) = _device_plan(
        tuple(a.offsets), tuple(b.offsets), n, itemsize, a.device)
    out = torch.empty((len(off_c), n), dtype=out_dtype, device=a.device)
    _build.launch("dia_spgemm_fused", _K3_ARGS, a.device,
                  a_data.data_ptr(), b_data.data_ptr(), out.data_ptr(),
                  groups.data_ptr(), rows.data_ptr(), plane_terms.data_ptr(),
                  terms.data_ptr(), len(plan.groups), plan.ntiles, plan.tile,
                  k, n, plan.smem, plan.lanes, plan.warps, int(plan.staged),
                  int(itemsize == 8))
    dia_spgemm_fused.launches += 1
    return DIA(out, tuple(off_c), (a.m, n))


dia_spgemm_fused.launches = 0
