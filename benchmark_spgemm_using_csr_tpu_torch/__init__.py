"""benchmark_spgemm_using_csr_tpu_torch — the PyTorch/CUDA port of
``benchmark_spgemm_using_csr_tpu`` for NVIDIA Hopper (H100).

C = A @ B on CSR through ``spgemm(a, b, method="auto")``: symbolic pass,
host plan + cost-model dispatch, then one numeric core. The ESC cores
(chunked / grouped / tilepack, tilepack through the hand-written CUDA
kernel K1 ``ops/kernels.tile_sort_merge``) carry irregular matrices; the
DIA path (``sparse/dia.py``, ``ops/dia.py``, kernel K3
``ops/dia_kernels.dia_spgemm_fused``, and K4 ``ops/dia_convert.dia_to_csr``
behind ``DIA.to_csr``) carries stencil and banded ones. The
tiled, binned and fused paths (kernel K2 ``ops/kernels.bin_sort_compress``)
are reached by name; the bsr and dense paths (batched dense products) carry
block-dense and near-dense products, and the hash path and the out-of-core
``spgemm_batched`` complete the SpGEMM methods. SpMV/SpMM, SpAdd, SpTRSV,
structure reuse (``ops/reuse``, ``ops/aggrap``) and the ``BhSparse``
lifecycle facade sit on the same containers, and the ``models`` subpackage
(AMG, ILU0) on top of them. The
reference package stays the specification: the containers, plans and
outputs follow its conventions buffer for buffer.

The package imports torch and never jax.
"""
from .sparse.csr import (
    BSR,
    COO,
    CSR,
    csr_gather_rows,
    csr_transpose,
    pad_bucket,
)
from .sparse.dia import DIA
from .ops.dispatch import choose_method
from .api import spgemm, spgemm_flops, nnz_upper_bound
from .ops.esc import spgemm_esc_padded
from .ops.chunked import make_chunked_plan, spgemm_chunked
from .ops.grouped import make_grouped_plan, spgemm_grouped
from .ops.tilepack import make_tilepack_plan, spgemm_tilepack
from .ops.dia import dia_spgemm, dia_spmv, dia_viable, spgemm_dia
from .ops.dia_kernels import dia_spgemm_fused
from .ops.tiled import make_tiled_plan, spgemm_tiled
from .ops.binned import spgemm_binned_host
from .ops.bsr import bsr_spgemm, make_bsr_plan, spgemm_bsr
from .ops.dense import make_dense_plan, spgemm_dense, spgemm_dense_auto
from .ops.hash import spgemm_hash
from .ops.fused import make_plan as make_fused_plan, spgemm_fused
from .ops.batched import make_batched_plan, spgemm_batched
from .ops.spmv import bsr_spmm, spmm, spmv, spmv_t
from .ops.spadd import make_add_plan, spadd, spadd_planned
from .ops.sptrsv import ilu0_apply_exact, make_trsv_plan, sptrsv, sptrsv_planned
from .ops.reuse import make_numeric_plan, spgemm_numeric
from .compat import BhSparse
from . import models

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "DIA",
    "csr_gather_rows",
    "csr_transpose",
    "pad_bucket",
    "choose_method",
    "spgemm",
    "spgemm_flops",
    "nnz_upper_bound",
    "spgemm_esc_padded",
    "make_chunked_plan",
    "spgemm_chunked",
    "make_grouped_plan",
    "spgemm_grouped",
    "make_tilepack_plan",
    "spgemm_tilepack",
    "dia_spgemm",
    "dia_spgemm_fused",
    "dia_spmv",
    "dia_viable",
    "spgemm_dia",
    "make_tiled_plan",
    "spgemm_tiled",
    "spgemm_binned_host",
    "BSR",
    "bsr_spgemm",
    "make_bsr_plan",
    "spgemm_bsr",
    "make_dense_plan",
    "spgemm_dense",
    "spgemm_dense_auto",
    "spgemm_hash",
    "make_fused_plan",
    "spgemm_fused",
    "make_batched_plan",
    "spgemm_batched",
    "spmv",
    "spmm",
    "bsr_spmm",
    "spmv_t",
    "make_add_plan",
    "spadd",
    "spadd_planned",
    "make_trsv_plan",
    "sptrsv",
    "sptrsv_planned",
    "ilu0_apply_exact",
    "make_numeric_plan",
    "spgemm_numeric",
    "BhSparse",
    "models",
]
