"""Kernel K7, ``pair_stats``: the structure-only integers the dispatcher
prices C = A·B from (``ops/dispatch``'s seven ``estimate_*_s``).

One call gives a ``PairStats``: the products and the nnz of both sides,
grouped's ceil-division sums, tilepack's chunk counts and, where its gates
pass, its greedy fill's tile count and most rows a tile, the distinct
diagonals of A and of B (their offsets where each has at most
``MAX_DIAGS``), and bsr's block pairs where the shapes divide. The
estimates compute their floats on the host from these integers exactly as
they did from numpy's passes over host copies, so every estimate, and every
pick, is the same.

CUDA operands (both on one device) run K7 (``csrc/pair_stats.cu``, built
with nvcc for sm_90a at first use): a few launches on the current stream
and one read back of a small int64 vector (one ``host.syncs``, counter
``dispatch.stats.device``); nothing is copied to the host's mirror
(``host_view``), so the plan the pick needs fills it. Other operands run the
plain version ``pair_stats_plain`` over host views. ``pair_stats`` holds
each pair's result by the identity of its four index buffers, weakly
(``IdentityMemo``), so a repeated call on the same tensors launches
nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..sparse.csr import (
    CSR,
    INDEX_DTYPE,
    IdentityMemo,
    host_view,
    sorted_unique,
)
from ..utils import profiling
from . import _build
from .tilepack import AL, MAX_W, tile_width

# the vector's fields, in csrc/pair_stats.cu's order: slots{c} is the sum
# over A's entries of ceil(|B row| / c), pad{c} the sum over B's rows of
# ceil(|B row| / c); max_chunks{,_set} the most chunks of 8 in a row of A
# without and with a chunk for each entry whose B row is empty; tiles and
# max_rows tilepack's greedy fill (0 where its gates refuse); nd_{a,b} the
# distinct diagonals; bsr_pairs None where the shapes do not divide
FIELDS = ("nnz_a", "nnz_b", "products", "rows_ne", "n_zero", "slots2",
          "slots4", "slots8", "pad2", "pad4", "pad8", "max_chunks",
          "max_chunks_set", "tiles", "max_rows", "nd_a", "nd_b", "bsr_pairs")
MAX_DIAGS = 4096  # offsets are listed for a matrix with at most this many
FILL_SEG = 4096  # rows of a segment of K7's fill
FILL_STATES = MAX_W // AL + 1  # the chunks tilepack's open tile may hold
BSR_BM, BSR_BK = 8, 128  # bsr's (8, 128) x (128, 128) blocks
BSR_SMEM_BYTES = 48 << 10  # a bsr bitmap in shared memory, at most
BSR_MAP_BYTES = 64 << 20  # the slices of one in device memory, at most

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_K7_ARGS = (_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _P, ctypes.c_int, _P,
            _P, _LL)

_PSTATS = IdentityMemo(8)


@dataclasses.dataclass(frozen=True)
class PairStats:
    nnz_a: int
    nnz_b: int
    products: int
    rows_ne: int
    n_zero: int
    slots2: int
    slots4: int
    slots8: int
    pad2: int
    pad4: int
    pad8: int
    max_chunks: int
    max_chunks_set: int
    tiles: int
    max_rows: int
    nd_a: int
    nd_b: int
    bsr_pairs: int | None
    offs_a: tuple | None  # sorted, where nd_a <= MAX_DIAGS
    offs_b: tuple | None

    def slots(self, c: int) -> int:
        return getattr(self, f"slots{c}")

    def pad(self, c: int) -> int:
        return getattr(self, f"pad{c}")


def bsr_divides(a: CSR, b: CSR) -> bool:
    """A blocks at (8, 128) and B at (128, 128), as ops/bsr does."""
    return not (a.m % BSR_BM or a.n % BSR_BK or b.m % BSR_BK or b.n % BSR_BK)


def fill_width(fields: dict):
    """tilepack's gates before its fill (``ops/tilepack.tile_width``) on the
    pair's integers: (w, scatter_set), or None where its plan refuses."""
    return tile_width(fields["nnz_a"], fields["n_zero"], fields["max_chunks"],
                      fields["max_chunks_set"], fields["products"])


def pair_stats(a: CSR, b: CSR) -> PairStats:
    """The pair's statistics: K7 where both operands are CUDA tensors on
    one device, else the plain version; memoized on the operands' index
    buffers."""
    key = (a.rowptr, a.colidx, b.rowptr, b.colidx)
    extra = (a.shape, b.shape)
    hit = _PSTATS.get(key, extra)
    if hit is not None:
        return hit
    if a.device.type == "cuda" and b.device == a.device:
        stats = _launch(a, b)
    else:
        stats = pair_stats_plain(a, b)
    return _PSTATS.put(key, extra, stats)


def _launch(a: CSR, b: CSR) -> PairStats:
    """K7 on the card and its vector read back once."""
    out, bsr = launch_k7(a, b)
    vec = out.cpu().tolist()
    profiling.count("host.syncs")
    profiling.count("dispatch.stats.device")
    fields = dict(zip(FIELDS, vec))
    if not bsr:
        fields["bsr_pairs"] = None
    offs = vec[len(FIELDS):]
    return _stats(fields, offs[:fields["nd_a"]],
                  offs[MAX_DIAGS:MAX_DIAGS + fields["nd_b"]])


def launch_k7(a: CSR, b: CSR) -> tuple[torch.Tensor, bool]:
    """K7's launches on the current stream: (its int64 vector on the
    device, whether it counted bsr's pairs). Nothing is read back."""
    m, k, n = a.m, a.n, b.n
    dev = a.device
    for x in (a.rowptr, a.colidx, b.rowptr, b.colidx):
        if x.dtype != INDEX_DTYPE or not x.is_contiguous():
            raise TypeError("pair_stats needs contiguous int32 structure")
    out = torch.empty(len(FIELDS) + 2 * MAX_DIAGS, dtype=torch.int64,
                      device=dev)
    words = -(-max(m + k - 1, 0) // 32) + -(-max(k + n - 1, 0) // 32)
    segs = -(-m // FILL_SEG)
    rows_at, diag_at = 0, 2 * m
    seg_at = diag_at + words
    bsr = bsr_divides(a, b)
    blen_at = seg_at + segs * FILL_STATES * 5
    map_at = blen_at + (k // BSR_BK if bsr else 0)
    slices = 0
    map_words = -(-max(k, n) // (BSR_BK * 32))
    if bsr and map_words * 4 > BSR_SMEM_BYTES:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = max(1, min(BSR_MAP_BYTES // (map_words * 4), 2 * sms))
    work = torch.empty(max(map_at + slices * map_words, 1),
                       dtype=INDEX_DTYPE, device=dev)
    at = work.data_ptr()
    _build.launch("pair_stats", _K7_ARGS, dev, a.rowptr.data_ptr(),
                  a.colidx.data_ptr(), b.rowptr.data_ptr(),
                  b.colidx.data_ptr(), m, k, n, out.data_ptr(),
                  at + 4 * rows_at, at + 4 * diag_at, at + 4 * seg_at,
                  int(bsr), at + 4 * blen_at, at + 4 * map_at, slices)
    pair_stats.launches += 1
    return out, bsr


pair_stats.launches = 0


def _stats(fields: dict, offs_a, offs_b) -> PairStats:
    return PairStats(
        **fields,
        offs_a=tuple(offs_a) if fields["nd_a"] <= MAX_DIAGS else None,
        offs_b=tuple(offs_b) if fields["nd_b"] <= MAX_DIAGS else None)


def _ceil_div(x: np.ndarray, c: int) -> np.ndarray:
    return -(-x // c)


def _diagonals(rowptr: np.ndarray, cols: np.ndarray, m: int, n: int):
    """The distinct diagonals (col - row) of an m x n matrix's entries,
    sorted, and every entry's row: a mark on each of its m + n - 1
    diagonals, no sort."""
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rowptr))
    seen = np.zeros(max(m + n - 1, 0), bool)
    seen[cols - rows + (m - 1)] = True
    return np.flatnonzero(seen) - (m - 1), rows


def greedy_fill(chunks: np.ndarray, wlr: int) -> tuple[int, int]:
    """tilepack's greedy fill of rows of ``chunks`` (each <= wlr; rows of 0
    take no tile) into tiles of ``wlr`` chunks, a row never straddling
    two: (tiles, the most rows in one, at least 1). A tile that starts at
    row i ends before the first row past ``wlr`` chunks from it; the tile
    starts are that jump's orbit from row 0, marked by pointer doubling."""
    c = np.asarray(chunks, np.int64)
    c = c[c > 0]
    rows = len(c)
    if not rows:
        return 1, 1
    cum = np.concatenate([[0], np.cumsum(c)])
    nxt = np.searchsorted(cum, cum[:-1] + wlr, side="right") - 1
    jump = np.append(nxt, rows)
    start = np.zeros(rows + 1, bool)
    start[0] = True
    while jump[0] < rows:  # every start fewer than 2^k jumps on is marked
        start[jump[start]] = True
        jump = jump[jump]
    first = np.flatnonzero(start[:rows])
    return len(first), max(int((nxt[first] - first).max()), 1)


def pair_stats_plain(a: CSR, b: CSR) -> PairStats:
    """K7's plain version: numpy passes over host views of the index
    buffers. A sum over A's entries of a function of their B row's length
    is the dot of that function over B's rows with how many entries of A
    name each row."""
    m, k = a.shape
    arp = host_view(a.rowptr)[:m + 1].astype(np.int64)
    brp = host_view(b.rowptr)[:k + 1].astype(np.int64)
    nnz_a, nnz_b = int(arp[-1]), int(brp[-1])
    a_cols = host_view(a.colidx)[:nnz_a]
    b_cols = host_view(b.colidx)[:nnz_b]
    b_len = np.diff(brp)
    uses = np.bincount(a_cols, minlength=k)
    empty = b_len == 0
    c8 = _ceil_div(b_len, AL)
    row_cum = np.concatenate([[0], np.cumsum(c8[a_cols])])
    row_chunks = row_cum[arp[1:]] - row_cum[arp[:-1]]
    n_zero = int(uses @ empty)
    row_set = row_chunks
    if n_zero:
        zero_cum = np.concatenate([[0], np.cumsum(empty[a_cols])])
        row_set = row_chunks + zero_cum[arp[1:]] - zero_cum[arp[:-1]]
    fields = dict(
        nnz_a=nnz_a, nnz_b=nnz_b, products=int(uses @ b_len),
        rows_ne=int(np.count_nonzero(arp[1:] > arp[:-1])), n_zero=n_zero,
        **{f"slots{c}": int(uses @ _ceil_div(b_len, c)) for c in (2, 4, 8)},
        **{f"pad{c}": int(_ceil_div(b_len, c).sum()) for c in (2, 4, 8)},
        max_chunks=int(row_chunks.max(initial=0)),
        max_chunks_set=int(row_set.max(initial=0)), tiles=0, max_rows=0)
    gate = fill_width(fields)
    if gate is not None:
        w, scatter_set = gate
        fields["tiles"], fields["max_rows"] = greedy_fill(
            row_set if scatter_set else row_chunks, w // AL)
    offs_a, a_rows = _diagonals(arp, a_cols, m, k)
    offs_b, b_rows = _diagonals(brp, b_cols, k, b.n)
    fields["nd_a"], fields["nd_b"] = len(offs_a), len(offs_b)
    fields["bsr_pairs"] = None
    if bsr_divides(a, b):
        kb, nb = k // BSR_BK, b.n // BSR_BK
        a_keys = sorted_unique((a_rows // BSR_BM) * kb + a_cols // BSR_BK)
        b_keys = sorted_unique((b_rows // BSR_BK) * nb + b_cols // BSR_BK)
        b_blen = np.bincount(b_keys // max(nb, 1), minlength=kb)
        fields["bsr_pairs"] = int(b_blen[a_keys % max(kb, 1)].sum())
    return _stats(fields, offs_a[:MAX_DIAGS].tolist(),
                  offs_b[:MAX_DIAGS].tolist())
