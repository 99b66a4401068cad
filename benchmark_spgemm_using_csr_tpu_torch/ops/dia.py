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
  for every plane, which ``fused=None`` takes for CUDA planes within its
  shift span.

``spgemm_dia`` is the CSR facade: CSR -> DIA (host plan), the product on
the device, DIA -> CSR on the device with exact zeros pruned.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sparse.csr import CSR
from ..sparse.dia import DIA, dia_offsets_of  # noqa: F401  (re-exported)
from .dia_kernels import dia_spgemm_fused, gather_form


def dia_spgemm(a: DIA, b: DIA, fused: bool | None = None) -> DIA:
    """C = A @ B on diagonal planes.

    Invalid slots stay exactly 0 because both inputs honour the DIA
    zero-outside-matrix invariant.

    fused: route through kernel K3. ``None`` takes K3 for every pair of
    CUDA planes in float32 or float64 whose B shift span is within K3's
    4096 (the reference's block ``bj``); CPU planes keep the gather form.
    This differs from the reference's gate (float32, nd_a * nd_b <= 81,
    n >= 2^18, span <= 4096, on the TPU), which was measured on a TPU v5e:
    on the H100 K3 beats the gather form on every DIA matrix of the suite,
    in float32 and float64 (PERF.md §6), and the two are bit-equal, so only
    which implementation runs changes, never a value.
    """
    k, n = a.n, b.n
    if k != b.m:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if fused is None:
        span = (max(0, max(b.offsets, default=0))
                + max(0, -min(b.offsets, default=0)))
        fused = (
            span <= 4096
            and torch.promote_types(a.dtype, b.dtype) in (torch.float32,
                                                          torch.float64)
            and a.device.type == "cuda"
            and b.device.type == "cuda"
        )
    if fused:
        return dia_spgemm_fused(a, b)
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
