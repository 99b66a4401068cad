"""Cost-model method dispatch for C = A @ B — the stage-2 analogue.

``choose_method`` estimates the time of each of the seven numeric backends
(chunked, bsr, dia, dense, tilepack, grouped, hash) and returns the argmin:
host-side numpy passes over the structure at plan time (the bsr and dia
estimates add a sort over every entry).

Every constant below was measured on a TPU v5e by the reference package
(``benchmark_spgemm_using_csr_tpu/ops/dispatch.py``), not yet calibrated
for the H100. They are kept as they are so that the dispatcher picks what
the reference picks; an H100 calibration replaces them in a later change.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR, IdentityMemo, host_view, sorted_unique
from ..sparse.dia import dia_offsets_of
from ..utils import profiling
from .stream import rc_pack_bits

# measured on a TPU v5e, not yet calibrated for the H100
CHUNKED_NS_PER_PRODUCT = 9.5
# (m, n) that miss both the int31 and the uint32 key packs of the
# reference's sort; plus an m-sized tail per product
CHUNKED_NS_PER_PRODUCT_UNPACKED = 12.6
CHUNKED_NS_M_TAIL = 169.0
CHUNKED_FIXED_S = 0.1e-3
# DIA gather form: fixed cost, per plane slot of the nd_a * nd_b terms, per
# term op; C's planes must fit DIA_PLANE_BYTES (measured on a TPU v5e, not
# yet calibrated for the H100)
DIA_FIXED_S = 0.02e-3
DIA_NS_PER_SLOT = 0.018
DIA_OP_OVERHEAD_S = 1.5e-6
DIA_PLANE_BYTES = 512 << 20
# BSR: per (8, 128) x (128, 128) block pair; the pair memory gate counts
# the A side only, as the reference does (measured on a TPU v5e, not yet
# calibrated for the H100)
BSR_NS_PER_PAIR = 35.0
BSR_FIXED_S = 0.03e-3
BSR_PAIR_BYTES = 2 << 30
# dense: matmul at the reference's float32 HIGHEST rate, a scatter-in per
# nonzero, log-step extraction passes over C at HBM rate (measured on a TPU
# v5e, not yet calibrated for the H100)
DENSE_FIXED_S = 0.3e-3
DENSE_MEM_BYTES = 1 << 30
MXU_F32_HIGHEST_FLOPS = 3.0e13
SCATTER_DESC_PER_S = 1.38e8
HBM_BYTES_PER_S = 8.0e11


# per-matrix host stats, keyed by the identity of (rowptr, colidx)
_MSTATS = IdentityMemo(8)


def _mstats(x: CSR):
    """One host copy of (rowptr, colidx) + per-matrix derived stats,
    memoized on the buffers' identities in a small LRU that holds them
    weakly (``IdentityMemo``): a recycled id() never returns another
    matrix's stats, and the memo keeps no index array alive."""
    hit = _MSTATS.get((x.rowptr, x.colidx))
    if hit is not None:
        return hit
    rowptr = host_view(x.rowptr)
    nnz = int(rowptr[-1])
    row_lens = np.diff(rowptr).astype(np.int64)
    cols = host_view(x.colidx)[:nnz].astype(np.int64)
    return _MSTATS.put((x.rowptr, x.colidx), (),
                       (rowptr, nnz, row_lens, cols))


def _stats(a: CSR, b: CSR | None = None):
    """Pair stats for C = A @ B: A's host arrays + the intermediate-product
    count sum_i |B[A.colidx[i], :]| (== the flop count / 2)."""
    b = a if b is None else b
    a_rowptr, nnz_a, a_row_lens, a_cols = _mstats(a)
    _, _, b_row_lens, _ = _mstats(b)
    products = int(b_row_lens[a_cols].sum()) if nnz_a else 0
    return a_rowptr, nnz_a, a_row_lens, a_cols, products


def estimate_chunked_s(
    a: CSR, b: CSR | None = None, products: int | None = None
) -> float:
    b = a if b is None else b
    if products is None:
        *_, products = _stats(a, b)
    m, n = a.m, b.n
    cbits = max(int(max(n - 1, 1)).bit_length(), 1)
    rbits = max(int(max(m - 1, 1)).bit_length(), 1)
    packed = rc_pack_bits(m, n) > 0 or cbits + rbits <= 32
    if packed:
        ns = CHUNKED_NS_PER_PRODUCT
    else:
        ns = CHUNKED_NS_PER_PRODUCT_UNPACKED + CHUNKED_NS_M_TAIL * m / max(
            products, 1
        )
    return CHUNKED_FIXED_S + products * ns * 1e-9


def estimate_tilepack_s(
    a: CSR, b: CSR | None = None, plans: dict | None = None
) -> float:
    """Packed-tile ESC model priced off the exact plan (the regime gate
    rejects long-row matrices before the greedy fill). Stage rates and the
    per-lane sort-kernel cost are the reference's TPU v5e fit. The plan it
    builds goes to ``plans["tilepack"]`` when ``plans`` is given."""
    b = a if b is None else b
    _, nnz, *_rest, products = _stats(a, b)
    if not nnz:
        return 0.0
    if products > (1 << 27):
        return float("inf")
    from .tilepack import make_tilepack_plan

    sched = make_tilepack_plan(a, b)
    if plans is not None:
        plans["tilepack"] = sched
    if sched is None:
        return float("inf")
    p = sched.plan
    lanes = p.t_cap * p.w
    lw = max(int(p.w - 1).bit_length(), 1)
    kernel_ns = 0.0122 * lw * (lw + 1) / 2 + 0.173 * p.wlr_eff
    passes = max(int(max(lanes // 4, 1)).bit_length(), 1)
    return (
        CHUNKED_FIXED_S
        + 2 * nnz / 1.30e8
        + p.abpad_cap / 2.28e8
        + p.s_cap / 1.94e8
        + lanes * kernel_ns * 1e-9
        + passes * lanes * 0.075e-9
    )


def estimate_grouped_s(a: CSR, b: CSR | None = None) -> float:
    """Grouped-ESC model: best of the narrow / aligned modes under the
    shared cost (grouped.estimate_mode_ns). float64 keeps the reference's
    2.2x factor of its double-word lane, so the dispatch agrees with it."""
    from .grouped import estimate_mode_ns

    b = a if b is None else b
    rowptr, nnz, _, cols, products = _stats(a, b)
    if not nnz or products == 0:
        return 0.0
    if products > (1 << 27):
        return float("inf")
    dtype = str(a.vals.dtype).replace("torch.", "")
    if dtype not in ("float32", "bfloat16", "float16", "float64"):
        return float("inf")
    m, n = a.m, b.n
    if max(int(n - 1).bit_length(), 1) > 31:
        return float("inf")
    _, _, b_row_lens, _ = _mstats(b)
    lens = b_row_lens[cols]
    cost = estimate_mode_ns(m, nnz, products, products, 0)
    for cand in (2, 4, 8):
        abpad_c = int((-(-b_row_lens // cand) * cand).sum())
        slots_c = int((-(-lens // cand)).sum()) * cand
        # mirror make_grouped_plan's table-size guard
        if abpad_c // cand > (512 << 10 if cand < 8 else 2 << 20):
            continue
        cost = min(
            cost,
            estimate_mode_ns(m, nnz, slots_c, slots_c // cand, abpad_c),
        )
    if dtype == "float64":
        cost *= 2.2
    return CHUNKED_FIXED_S + cost * 1e-9


def estimate_bsr_s(
    a: CSR, b: CSR | None = None, block_shape=(8, 128), bn: int = 128
) -> float:
    """Block-pair count model: A blocked at (bm, bk), B at (bk, bn), as
    ops/bsr.spgemm_bsr blocks them. Infinite when a shape does not divide
    or the A side of the pairs passes BSR_PAIR_BYTES."""
    b = a if b is None else b
    bm, bk = block_shape
    if a.m % bm or a.n % bk or b.m % bk or b.n % bn:
        return float("inf")
    a_rowptr, nnz_a, _, a_cols = _mstats(a)
    b_rowptr, nnz_b, _, b_cols = _mstats(b)
    if not nnz_a or not nnz_b:
        return 0.0
    a_rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(a_rowptr))
    a_keys = sorted_unique((a_rows // bm) * (a.n // bk) + a_cols // bk)
    b_rows = np.repeat(np.arange(b.m, dtype=np.int64), np.diff(b_rowptr))
    b_keys = sorted_unique((b_rows // bk) * (b.n // bn) + b_cols // bn)
    b_blen = np.bincount(b_keys // (b.n // bn), minlength=b.m // bk)
    pairs = int(b_blen[a_keys % (a.n // bk)].sum())
    if pairs * bm * bk * 4 > BSR_PAIR_BYTES:
        return float("inf")
    return BSR_FIXED_S + pairs * BSR_NS_PER_PAIR * 1e-9


def estimate_dense_s(a: CSR, b: CSR | None = None) -> float:
    """Dense model: the m * k * n matmul, the scatter of both operands and
    ~log2(m * n) extraction passes over C. Infinite when the three dense
    arrays pass DENSE_MEM_BYTES."""
    b = a if b is None else b
    m, k = a.shape
    n = b.n
    itemsize = a.vals.element_size()
    if (m * k + k * n + m * n) * itemsize > DENSE_MEM_BYTES:
        return float("inf")
    _, nnz_a, *_ = _mstats(a)
    _, nnz_b, *_ = _mstats(b)
    matmul_s = 2.0 * m * k * n / MXU_F32_HIGHEST_FLOPS
    scatter_s = (nnz_a + nnz_b) / SCATTER_DESC_PER_S
    passes = max(int(m * n).bit_length() - 8, 1)  # holes unknown pre-plan
    compact_s = passes * (m * n * (2 * itemsize + 1)) / HBM_BYTES_PER_S
    return DENSE_FIXED_S + matmul_s + scatter_s + compact_s


def estimate_hash_s(
    a: CSR, b: CSR | None = None, tile_bytes_budget: int = 512 * 1024 * 1024
) -> float:
    """Dense-accumulator model (ops/hash.py): a scatter-add and an
    occupancy scatter per product, an expansion gather per product, and per
    row tile an (R, n) prefix sum and two compaction scatters. The
    reference measured this path 75-120x slower than grouped on its TPU;
    that verdict is the TPU's and is not carried over."""
    b = a if b is None else b
    rowptr, nnz, _, _, products = _stats(a, b)
    if not nnz:
        return 0.0
    n = b.n
    itemsize = a.vals.element_size()
    r_tile = max(int(tile_bytes_budget // (n * (itemsize + 4 + 4))), 8)
    m_ne = int((np.diff(rowptr) > 0).sum())
    n_tiles = -(-m_ne // max(min(r_tile, m_ne), 1)) if m_ne else 0
    slots = n_tiles * min(r_tile, max(m_ne, 1)) * n
    return (
        CHUNKED_FIXED_S * max(n_tiles, 1)  # one host-orchestrated pass a tile
        + products / 1.30e8  # value scatter-add
        + products / 1.94e8  # occupancy scatter
        + products / 2.28e8  # product expansion gathers
        + slots * 0.8e-9  # per-tile prefix sum
        + 2 * slots / 1.4e8  # cols/vals compaction scatters
    )


def estimate_dia_s(a: CSR, b: CSR | None = None) -> float:
    """DIA gather-form model: nd_a * nd_b * n plane slots plus a per-term
    op overhead. Infinite where the reference refuses: more than 10 s of
    slots, more than 4096 diagonals, more terms than the cap (16384 when
    the product stream is >= 4M products, else 8192), or C's planes over
    DIA_PLANE_BYTES."""
    b = a if b is None else b
    _, nnz_a, *_ = _mstats(a)
    _, nnz_b, *_ = _mstats(b)
    if not nnz_a or not nnz_b:
        return 0.0
    offs_a = dia_offsets_of(a)
    offs_b = offs_a if b is a else dia_offsets_of(b)
    nd_a, nd_b = len(offs_a), len(offs_b)
    *_, products = _stats(a, b)
    term_cap = 16384 if products >= (1 << 22) else 8192
    if (
        nd_a * nd_b * b.n * DIA_NS_PER_SLOT * 1e-9 > 10.0
        or nd_a > 4096
        or nd_b > 4096
        or nd_a * nd_b > term_cap
    ):
        return float("inf")
    n_off_c = len(np.unique(offs_a[:, None] + offs_b[None, :]))
    if n_off_c * b.n * a.vals.element_size() > DIA_PLANE_BYTES:
        return float("inf")
    # the per-term op overhead generalizes from A @ A as
    # terms / max(nd_a, nd_b)
    return (
        DIA_FIXED_S
        + nd_a * nd_b * b.n * DIA_NS_PER_SLOT * 1e-9
        + (nd_a * nd_b / max(nd_a, nd_b, 1)) * DIA_OP_OVERHEAD_S
    )


def choose_method(
    a: CSR, b: CSR | None = None, plans: dict | None = None
) -> str:
    """Pick the fastest backend for C = A @ B by cost model
    (B defaults to A — the reference's squaring benchmark mode).
    ``plans``, when given, receives the host plans the estimators built
    (key "tilepack"), so the caller need not build them again."""
    b = a if b is None else b
    with profiling.span("dispatch.choose"):
        with profiling.span("dispatch.stats"):
            *_, products = _stats(a, b)
        if products == 0:
            return "chunked"  # degenerate product; every estimate ties at ~0
        estimates = {
            # the reference's order, which decides ties
            "chunked": lambda: estimate_chunked_s(a, b, products),
            "bsr": lambda: estimate_bsr_s(a, b),
            "dia": lambda: estimate_dia_s(a, b),
            "dense": lambda: estimate_dense_s(a, b),
            "tilepack": lambda: estimate_tilepack_s(a, b, plans),
            "grouped": lambda: estimate_grouped_s(a, b),
            "hash": lambda: estimate_hash_s(a, b),
        }
        est = {}
        for name, estimate in estimates.items():
            with profiling.span(f"dispatch.estimate.{name}"):
                est[name] = estimate()
        return min(est, key=est.get)
