"""Framework facade: ``spgemm(A, B) -> CSR``, the equivalent of the
reference benchmark's ``bhsparse`` class (initData / spgemm / get_C).

The host wrapper sizes the one dynamic quantity, the output, with
power-of-two growth buckets, and routes ``method="auto"`` through the
cost-model dispatch (ops/dispatch). Every step runs on the device of the
operands; reading the product count and trimming C read scalars back to the
host, so a CUDA call synchronises there.
"""
from __future__ import annotations

from .config import DEFAULT
from .ops import symbolic
from .ops.esc import spgemm_esc_padded
from .sparse.csr import CSR, pad_bucket
from .utils import profiling


def resolve_method(a: CSR, b: CSR, plans: dict | None = None) -> str:
    """The method ``spgemm(a, b, method="auto")`` runs: the cost model's
    pick (ops/dispatch), or chunked where the pick is tilepack or grouped
    and its plan refuses the operands (the cost model and the plans share
    regime gates, but a plan sees statics the estimator approximates).
    ``plans``, when given, receives the pick's host plan, built after the
    pick (keys "tilepack" and "grouped")."""
    from .ops.dispatch import choose_method

    plans = {} if plans is None else plans
    method = choose_method(a, b)
    with profiling.span("api.plan"):
        if method == "tilepack":
            from .ops.tilepack import make_tilepack_plan

            plans["tilepack"] = make_tilepack_plan(a, b)
        elif method == "grouped":
            from .ops.grouped import make_grouped_plan

            plans["grouped"] = make_grouped_plan(a, b)
    if method in ("tilepack", "grouped") and plans[method] is None:
        return "chunked"
    return method


def spgemm(
    a: CSR,
    b: CSR,
    *,
    method: str | None = None,
    trim: bool | None = None,
    config=None,
) -> CSR:
    """C = A @ B.

    method: 'auto' (cost-model dispatch, ``resolve_method``), 'esc',
    'chunked', 'bsr', 'dense', 'dia', 'fused', 'binned', 'hash', 'tiled',
    'tilepack' or 'grouped'. Explicit kwargs override ``config`` (a
    SpGemmConfig).
    trim: shrink C's padded buffers to pad_bucket(nnzC).
    """
    config = config or DEFAULT
    method = method if method is not None else config.method
    trim = trim if trim is not None else config.trim
    with profiling.span("api.spgemm"):
        if a.n != b.m:
            raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
        if a.device != b.device:
            raise ValueError(f"operands on {a.device} and {b.device}")
        plans = {}  # host plans built while resolving "auto"
        if method == "auto":
            method = resolve_method(a, b, plans)
        if method == "chunked":
            from .ops.chunked import make_chunked_plan, spgemm_chunked

            c = spgemm_chunked(a, b, make_chunked_plan(a, b))
        elif method == "bsr":
            from .ops.bsr import spgemm_bsr

            c = spgemm_bsr(a, b)
        elif method == "dense":
            from .ops.dense import spgemm_dense_auto

            c = spgemm_dense_auto(a, b)
        elif method == "fused":
            from .ops.fused import make_plan as _make_fused_plan, spgemm_fused

            c = spgemm_fused(a, b, _make_fused_plan(a, b,
                                                    widths=config.bin_widths))
        elif method == "hash":
            from .ops.hash import spgemm_hash

            c = spgemm_hash(a, b)
        elif method == "esc":
            prod_capacity = pad_bucket(int(symbolic.total_products(a, b)))
            c = spgemm_esc_padded(a, b, prod_capacity, prod_capacity)
        elif method == "tilepack":
            from .ops.tilepack import make_tilepack_plan, spgemm_tilepack

            sched = (plans["tilepack"] if "tilepack" in plans
                     else make_tilepack_plan(a, b))
            if sched is None:
                raise ValueError("matrix outside the packed-tile regime "
                                 "(short rows, float32)")
            c = spgemm_tilepack(a, b, sched)
        elif method == "grouped":
            from .ops.grouped import make_grouped_plan, spgemm_grouped

            gsched = (plans["grouped"] if "grouped" in plans
                      else make_grouped_plan(a, b))
            if gsched is None:
                raise ValueError(
                    "matrix outside the grouped regime (float32/float64 "
                    "values, nonzero products)")
            c = spgemm_grouped(a, b, gsched)
        elif method == "dia":
            from .ops.dia import spgemm_dia

            c = spgemm_dia(a, b)
        elif method == "tiled":
            from .ops.tiled import make_tiled_plan, spgemm_tiled

            tplan = make_tiled_plan(a, b)
            if tplan is None:
                raise ValueError(
                    "matrix outside the tiled regime (uniform short rows)"
                )
            c = spgemm_tiled(a, b, tplan)
        elif method == "binned":
            from .ops.binned import spgemm_binned_host

            prod_capacity = pad_bucket(int(symbolic.total_products(a, b)))
            c = spgemm_binned_host(a, b, prod_capacity=prod_capacity,
                                   widths=config.bin_widths)
        else:
            raise ValueError(f"unknown method {method!r}")
        if trim:
            profiling.count("host.syncs")
            c = c.with_capacity(pad_bucket(int(c.rowptr[-1])))
        return c


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Canonical flop count 2 * sum_i nnzCt[i]."""
    return 2 * int(symbolic.total_products(a, b))


def nnz_upper_bound(a: CSR, b: CSR):
    return symbolic.nnz_upper_bound(a, b)
