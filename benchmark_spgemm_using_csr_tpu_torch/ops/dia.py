"""SpGEMM / SpMV on DIA (diagonal) storage: static-shift plane arithmetic.

For diagonal-structured matrices (stencils, bands) the product's structure
is known from the offsets alone: ``C`` lives on the offset sums
``d1 + d2``, and every term

    C[dc, j] += A[d1, j - d2] * B[d2, j]        (dc = d1 + d2)

is a shifted elementwise multiply-add over length-n planes, with no gather
and no sort. ``dia_spgemm`` computes it in one of two forms, as the
reference package's ``ops/dia.py`` does:

- the gather form (``ops/dia_kernels.gather_form``, torch ops, as the
  reference leaves it to XLA; also K3's plain version): each output plane
  is a sum of its shifted terms, in ascending B slot;
- the fused kernel K3 (``ops/dia_kernels.dia_spgemm_fused``), one launch
  for every plane, which ``fused=None`` takes for CUDA planes.

``spgemm_dia`` is the CSR facade: CSR -> DIA (host plan), the product on
the device, DIA -> CSR on the device with exact zeros pruned.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, host_view
from ..sparse.dia import DIA, dia_offsets_of
from ..utils import profiling
from .dia_kernels import dia_spgemm_fused, gather_form

# the reference's block ``bj``: K3's shift span in the reference contract
K3_BJ = 4096
# dia_viable's constants, the reference's measurements on a TPU v5e: C's
# planes at most this many bytes, the chunked path's cost per product, a
# plane slot's FMA and an op's overhead
VIABLE_MAX_PLANE_BYTES = 512 << 20
V5E_CHUNKED_NS_PER_PRODUCT = 15.0
V5E_DIA_NS_PER_SLOT = 0.1
V5E_OP_OVERHEAD_S = 25e-6


def dia_spgemm(a: DIA, b: DIA, fused: bool | None = None) -> DIA:
    """C = A @ B on diagonal planes.

    Invalid slots stay exactly 0 because both inputs honour the DIA
    zero-outside-matrix invariant.

    fused: route through kernel K3. ``None`` takes K3 for CUDA planes and
    the gather form, K3's plain version, for CPU planes. This differs from
    the reference's gate (float32, nd_a * nd_b <= 81, n >= 2^18, span <=
    4096, on the TPU), which was measured on a TPU v5e: on the H100 K3
    beats the gather form on every DIA matrix of the suite, in float32 and
    float64 (PERF.md §6), and the two are bit-equal, so only which
    implementation runs changes, never a value. K3 is called with its
    block ``bj`` widened to B's shift span where the span passes the
    reference's 4096 (the CUDA kernel needs no block of ``bj`` columns;
    ``dia_spgemm_fused`` keeps the bound only for the reference's
    contract).
    """
    k, n = a.n, b.n
    if k != b.m:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if fused is None:
        fused = a.device.type == "cuda"
    with profiling.span("dia.spgemm"):
        if fused:
            span = (max(0, max(b.offsets, default=0))
                    + max(0, -min(b.offsets, default=0)))
            return dia_spgemm_fused(a, b, bj=max(K3_BJ, span))
        return gather_form(a, b)


def dia_spmv(a: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via static-shift adds: y[i] = sum_s (A_s * x)[i + d_s]."""
    m, k = a.shape
    out_dtype = torch.promote_types(a.dtype, x.dtype)
    y = torch.zeros(m, dtype=out_dtype, device=a.device)
    if not a.offsets:
        return y
    t = a.data.to(out_dtype) * x[None, :].to(out_dtype)  # (nd, k)
    pad_l = max(0, -min(a.offsets))
    pad_r = max(0, m + max(a.offsets) - k)
    t_pad = torch.nn.functional.pad(t, (pad_l, pad_r))
    for s, d in enumerate(a.offsets):
        start = pad_l + d
        y = y + t_pad[s, start:start + m]
    return y


def dia_viable(a: CSR) -> bool:
    """The reference's cost test for C = A @ A on DIA (host, plan time):
    ndiag^2 * n plane-slot FMAs plus an op overhead per B diagonal against
    the chunked path's cost per intermediate product, and C's planes
    within ``VIABLE_MAX_PLANE_BYTES``. The constants are the reference's
    TPU v5e measurements; ``ops/dispatch.estimate_dia_s`` is the
    dispatcher's own DIA price."""
    offs = dia_offsets_of(a)
    nd = len(offs)
    if nd == 0:
        return True
    # many-diagonal matrices can never win on the nd^2 * n cost, and their
    # offset-sum table would be huge: out before building it
    if nd > 4096 or nd * nd * a.n * V5E_DIA_NS_PER_SLOT * 1e-9 > 10.0:
        return False
    n_off_c = len(np.unique(offs[:, None] + offs[None, :]))
    if n_off_c * a.n * a.vals.element_size() > VIABLE_MAX_PLANE_BYTES:
        return False
    rowptr = host_view(a.rowptr)
    nnz = int(rowptr[-1])
    row_lens = np.diff(rowptr).astype(np.int64)
    cols = host_view(a.colidx)[:nnz].astype(np.int64)
    products = int(row_lens[cols].sum())
    dia_s = (nd * nd * a.n * V5E_DIA_NS_PER_SLOT * 1e-9
             + nd * V5E_OP_OVERHEAD_S)
    return dia_s < products * V5E_CHUNKED_NS_PER_PRODUCT * 1e-9


def spgemm_dia(a_csr: CSR, b_csr: CSR) -> CSR:
    """CSR -> DIA -> multiply -> CSR. Plane slots that compute to exactly
    0.0 are structurally absent in the true C and are pruned, so the CSR
    structure matches the scalar paths. bfloat16 values give float32
    planes (``DIA.from_csr``), and C's values are rounded back."""
    a_d = DIA.from_csr(a_csr, device=a_csr.device)
    b_d = a_d if b_csr is a_csr else DIA.from_csr(b_csr, device=b_csr.device)
    c = dia_spgemm(a_d, b_d).to_csr(prune=True)
    out_dtype = torch.promote_types(a_csr.dtype, b_csr.dtype)
    if c.vals.dtype != out_dtype:
        c = dataclasses.replace(c, vals=c.vals.to(out_dtype))
    return c
