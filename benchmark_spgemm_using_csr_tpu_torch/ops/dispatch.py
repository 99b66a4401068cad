"""Cost-model method dispatch for C = A @ B — the stage-2 analogue.

``choose_method`` estimates the time of each of the seven numeric backends
(chunked, bsr, dia, dense, tilepack, grouped, hash) and returns the argmin.
Every estimate reads the pair's structure-only integers from
``ops/pair_stats.pair_stats`` (kernel K7 on CUDA operands, its plain version
on the host otherwise) and computes its float from them on the host.

Every constant below was measured on a TPU v5e by the reference package
(``benchmark_spgemm_using_csr_tpu/ops/dispatch.py``), not yet calibrated
for the H100. They are kept as they are so that the dispatcher picks what
the reference picks; an H100 calibration replaces them in a later change.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR
from ..utils import profiling
from .pair_stats import BSR_BK, BSR_BM, bsr_divides, fill_width, pair_stats
from .stream import F32_PACKABLE, MAX_PRODUCTS, rc_pack_bits
from .tilepack import AL, fill_statics

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


def estimate_chunked_s(
    a: CSR, b: CSR | None = None, products: int | None = None
) -> float:
    b = a if b is None else b
    if products is None:
        products = pair_stats(a, b).products
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


def estimate_tilepack_s(a: CSR, b: CSR | None = None) -> float:
    """Packed-tile ESC model priced off the statics tilepack's plan would
    have (``ops/tilepack.make_tilepack_plan``: its gates, tile width and
    greedy fill, from the pair's statistics; the plan itself is built only
    where tilepack runs). Stage rates and the per-lane sort-kernel cost are
    the reference's TPU v5e fit."""
    b = a if b is None else b
    s = pair_stats(a, b)
    if not s.nnz_a:
        return 0.0
    gate = fill_width(vars(s))
    if gate is None or a.vals.dtype not in F32_PACKABLE:
        return float("inf")
    w, _ = gate
    statics = fill_statics(s.tiles, s.max_rows, AL * s.pad8, b.n)
    if statics is None:
        return float("inf")
    t_cap, wlr_eff, _, abpad_cap = statics
    wlr = w // AL
    lanes = t_cap * w
    lw = max(int(w - 1).bit_length(), 1)
    kernel_ns = 0.0122 * lw * (lw + 1) / 2 + 0.173 * wlr_eff
    passes = max(int(max(lanes // 4, 1)).bit_length(), 1)
    return (
        CHUNKED_FIXED_S
        + 2 * s.nnz_a / 1.30e8
        + abpad_cap / 2.28e8
        + t_cap * wlr / 1.94e8
        + lanes * kernel_ns * 1e-9
        + passes * lanes * 0.075e-9
    )


def estimate_grouped_s(a: CSR, b: CSR | None = None) -> float:
    """Grouped-ESC model: best of the narrow / aligned modes under the
    shared cost (grouped.estimate_mode_ns). float64 keeps the reference's
    2.2x factor of its double-word lane, so the dispatch agrees with it."""
    from .grouped import estimate_mode_ns

    b = a if b is None else b
    s = pair_stats(a, b)
    nnz, products = s.nnz_a, s.products
    if not nnz or products == 0:
        return 0.0
    if products > MAX_PRODUCTS:
        return float("inf")
    dtype = str(a.vals.dtype).replace("torch.", "")
    if dtype not in ("float32", "bfloat16", "float16", "float64"):
        return float("inf")
    m, n = a.m, b.n
    if max(int(n - 1).bit_length(), 1) > 31:
        return float("inf")
    cost = estimate_mode_ns(m, nnz, products, products, 0)
    for cand in (2, 4, 8):
        abpad_c = s.pad(cand) * cand
        slots_c = s.slots(cand) * cand
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


def estimate_bsr_s(a: CSR, b: CSR | None = None) -> float:
    """Block-pair count model: A blocked at (8, 128), B at (128, 128), as
    ops/bsr.spgemm_bsr blocks them. Infinite when a shape does not divide
    or the A side of the pairs passes BSR_PAIR_BYTES."""
    b = a if b is None else b
    if not bsr_divides(a, b):
        return float("inf")
    s = pair_stats(a, b)
    if not s.nnz_a or not s.nnz_b:
        return 0.0
    if s.bsr_pairs * BSR_BM * BSR_BK * 4 > BSR_PAIR_BYTES:
        return float("inf")
    return BSR_FIXED_S + s.bsr_pairs * BSR_NS_PER_PAIR * 1e-9


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
    s = pair_stats(a, b)
    matmul_s = 2.0 * m * k * n / MXU_F32_HIGHEST_FLOPS
    scatter_s = (s.nnz_a + s.nnz_b) / SCATTER_DESC_PER_S
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
    s = pair_stats(a, b)
    if not s.nnz_a:
        return 0.0
    n = b.n
    itemsize = a.vals.element_size()
    r_tile = max(int(tile_bytes_budget // (n * (itemsize + 4 + 4))), 8)
    m_ne = s.rows_ne
    n_tiles = -(-m_ne // max(min(r_tile, m_ne), 1)) if m_ne else 0
    slots = n_tiles * min(r_tile, max(m_ne, 1)) * n
    return (
        CHUNKED_FIXED_S * max(n_tiles, 1)  # one host-orchestrated pass a tile
        + s.products / 1.30e8  # value scatter-add
        + s.products / 1.94e8  # occupancy scatter
        + s.products / 2.28e8  # product expansion gathers
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
    s = pair_stats(a, b)
    if not s.nnz_a or not s.nnz_b:
        return 0.0
    nd_a, nd_b = s.nd_a, s.nd_b
    term_cap = 16384 if s.products >= (1 << 22) else 8192
    if (
        nd_a * nd_b * b.n * DIA_NS_PER_SLOT * 1e-9 > 10.0
        or nd_a > 4096
        or nd_b > 4096
        or nd_a * nd_b > term_cap
    ):
        return float("inf")
    offs_a, offs_b = np.asarray(s.offs_a), np.asarray(s.offs_b)
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


def choose_method(a: CSR, b: CSR | None = None) -> str:
    """Pick the fastest backend for C = A @ B by cost model
    (B defaults to A — the reference's squaring benchmark mode)."""
    b = a if b is None else b
    with profiling.span("dispatch.choose"):
        with profiling.span("dispatch.stats"):
            products = pair_stats(a, b).products
        if products == 0:
            return "chunked"  # degenerate product; every estimate ties at ~0
        estimates = {
            # the reference's order, which decides ties
            "chunked": lambda: estimate_chunked_s(a, b, products),
            "bsr": lambda: estimate_bsr_s(a, b),
            "dia": lambda: estimate_dia_s(a, b),
            "dense": lambda: estimate_dense_s(a, b),
            "tilepack": lambda: estimate_tilepack_s(a, b),
            "grouped": lambda: estimate_grouped_s(a, b),
            "hash": lambda: estimate_hash_s(a, b),
        }
        est = {}
        for name, estimate in estimates.items():
            with profiling.span(f"dispatch.estimate.{name}"):
                est[name] = estimate()
        return min(est, key=est.get)
