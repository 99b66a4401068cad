"""Kernel K3, the fused multi-plane DIA product, with its plain PyTorch
version.

``dia_spgemm_fused`` replaces the reference package's Pallas kernel
``ops/dia_pallas.py::dia_spgemm_fused``: C = A @ B on diagonal planes,
``C[dc][j] = sum_{d1 + d2 = dc} A[d1][j - d2] * B[d2][j]``, with output
offsets ``sorted{d1 + d2}``. The CUDA source is
``csrc/dia_spgemm_fused.cu``, built with nvcc for sm_90a at first use and
called through ctypes on PyTorch's current stream. Each output plane's sum
starts from its first term and adds the others in ascending B slot, without
contracting into an FMA, so the kernel equals its plain version, the gather
form that ``ops/dia.dia_spgemm`` runs off the kernel, bit for bit.

Dispatch is by the device of the planes: CPU tensors run the plain
version, CUDA tensors run the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sparse.dia import DIA
from . import _build

# the C entry point's arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K3_ARGS = (_P,) * 5 + (_I, _LL, _LL, _I)


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
    off_c, _ = plan_terms(a.offsets, b.offsets)
    if not off_c:
        return None
    pad_l = max(0, max(b.offsets))
    span = pad_l + max(0, -min(b.offsets))
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
    off_c, terms = plan_terms(a.offsets, b.offsets)
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


@functools.lru_cache(maxsize=64)
def _term_table(off_a: tuple, off_b: tuple, device: torch.device):
    """The kernel's term table on ``device``, built once per offset pair:
    ``plane_ptr`` (nd_c + 1,) and ``terms`` (T, 3) int32 rows (s1, s2,
    d2), a CSR over the output planes."""
    off_c, terms = plan_terms(off_a, off_b)
    counts = [len(terms[dc]) for dc in off_c]
    plane_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    flat = np.asarray([t for dc in off_c for t in terms[dc]], np.int32)
    return (torch.from_numpy(plane_ptr).to(device),
            torch.from_numpy(flat.reshape(-1, 3)).to(device))


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
    device = torch.device("cuda", a.device.index
                          if a.device.index is not None
                          else torch.cuda.current_device())
    plane_ptr, terms = _term_table(tuple(a.offsets), tuple(b.offsets), device)
    k, n = a.n, b.n
    out = torch.empty((len(off_c), n), dtype=out_dtype, device=a.device)
    _build.launch("dia_spgemm_fused", _K3_ARGS, a.device,
                  a_data.data_ptr(), b_data.data_ptr(), out.data_ptr(),
                  plane_ptr.data_ptr(), terms.data_ptr(), len(off_c), k, n,
                  int(out_dtype == torch.float64))
    dia_spgemm_fused.launches += 1
    return DIA(out, tuple(off_c), (a.m, n))


dia_spgemm_fused.launches = 0
