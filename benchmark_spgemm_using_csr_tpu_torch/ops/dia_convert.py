"""Kernel K4, DIA -> CSR on the device, with its plain PyTorch version.

``DIA.to_csr`` ends the dia path: the product's planes become C's CSR.
The offsets are sorted, so a row's slots taken in offset order are already
in column order, and each (row, column) lies on one plane: no sort and no
sum is needed, only a count, a scan and a copy. ``dia_to_csr`` runs the
CUDA kernel ``csrc/dia_to_csr.cu`` (built with nvcc for sm_90a at first
use, called through ctypes on PyTorch's current stream) for CUDA planes
and raises on what it does not take; CPU planes run
``dia_to_csr_plain``. Neither reads anything back to the host on the
kernel's path: C's capacity comes from the offsets and the shape alone,
``pad_bucket`` of the in-matrix slot count (an upper bound on nnz with
``prune``, exact without), and the tail past nnz is zero. The two give
bit-equal rowptr, colidx and vals (values are copied, never summed).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from ..utils import profiling
from . import _build

# the C entry point's arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K4_ARGS = (_P, _P, _I, _LL, _LL, _I, _P, _P, _P, _P, _LL, _I, _I, _I)

THREADS = 256  # a block of the kernel (csrc/dia_to_csr.cu kThreads)
ROWS = (256, 128, 64, 32)  # rows a block may take, most first
SMEM_BUDGET = 48 * 1024  # a fill block's staging buffers, at most
INT32_MAX = 2**31 - 1


def slot_count(offsets, m: int, n: int) -> int:
    """The in-matrix slots of planes at ``offsets`` for an (m, n) matrix:
    rows r in [0, m) with column r + off in [0, n), summed over the
    offsets."""
    return sum(max(0, min(m, n - off) - max(0, -off)) for off in offsets)


def capacity(offsets, m: int, n: int) -> int:
    """C's capacity, the same on both devices: ``pad_bucket`` of the
    in-matrix slot count."""
    return pad_bucket(slot_count(offsets, m, n))


def _empty(m: int, n: int, dtype, device) -> CSR:
    return CSR(rowptr=torch.zeros(m + 1, dtype=INDEX_DTYPE, device=device),
               colidx=torch.zeros(8, dtype=INDEX_DTYPE, device=device),
               vals=torch.zeros(8, dtype=dtype, device=device), shape=(m, n))


def dia_to_csr_plain(d, prune: bool = True) -> CSR:
    """Plain PyTorch version of K4, on any device: every kept slot's key
    row * n + col by boolean masks, sorted, rows counted by ``index_add_``,
    at the capacity of ``capacity``."""
    m, n = d.shape
    if d.ndiag == 0:
        return _empty(m, n, d.dtype, d.device)
    dev = d.device
    # blocking on a device: the copy of the offsets to it, then the three
    # boolean masks
    profiling.count("host.syncs", 4)
    offs = torch.tensor(d.offsets, dtype=torch.int64, device=dev)
    col = torch.arange(n, dtype=torch.int64, device=dev)
    row = col[None, :] - offs[:, None]
    keep = (row >= 0) & (row < m)
    if prune:
        keep &= d.data != 0
    # each (row, col) lies on one diagonal: the keys are unique
    key = row[keep] * n + col.expand(d.ndiag, n)[keep]
    vals = d.data[keep]
    key, order = torch.sort(key)
    vals = vals[order]
    nnz = key.shape[0]
    counts = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.div(key, n, rounding_mode="floor"),
                      torch.ones_like(key))
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:m], 0)])
    cap = capacity(d.offsets, m, n)
    colidx = torch.zeros(cap, dtype=INDEX_DTYPE, device=dev)
    out_vals = torch.zeros(cap, dtype=d.dtype, device=dev)
    colidx[:nnz] = (key % n).to(INDEX_DTYPE)
    out_vals[:nnz] = vals
    return CSR(rowptr=rowptr.to(INDEX_DTYPE), colidx=colidx, vals=out_vals,
               shape=(m, n))


@dataclasses.dataclass(frozen=True)
class Plan:
    """What K4 needs from the offsets and the shape: the offsets on the
    device (int32), C's capacity, the rows a block takes (a power of two,
    32 to 256: the most whose slots fit the staging window, so that a
    block's output is staged in one pass; its THREADS threads split each
    row's planes into THREADS / rows chunks), the blocks (at least one),
    and the output slots a fill block stages at once (a multiple of 4)."""

    offsets: torch.Tensor
    cap: int
    rows: int
    blocks: int
    window: int


@functools.lru_cache(maxsize=64)
def plan(offsets: tuple, m: int, n: int, itemsize: int,
         device: torch.device) -> Plan:
    """K4's plan, built once per offsets, shape, item size and device (the
    offsets' one copy to the device happens here)."""
    slots = slot_count(offsets, m, n)
    if slots > INT32_MAX:
        raise ValueError(f"{slots} in-matrix slots: int32 CSR holds at most "
                         f"{INT32_MAX}")
    most = (SMEM_BUDGET // (4 + itemsize) - 4) // 4 * 4
    rows = next((r for r in ROWS if r * len(offsets) <= most), ROWS[-1])
    return Plan(offsets=torch.tensor(offsets, dtype=torch.int32,
                                     device=device),
                cap=pad_bucket(slots), rows=rows,
                blocks=max(1, -(-m // rows)),
                window=min(most, -(-rows * len(offsets) // 4) * 4))


def dia_to_csr(d, prune: bool = True) -> CSR:
    """C's CSR from diagonal planes with one call of kernel K4 (three
    launches on the current stream, no read back to the host). ``prune``
    drops slots that hold exactly 0 (DIA planes over-approximate the
    structure); without it every in-matrix slot is kept. CUDA planes must
    be float32 or float64 and contiguous; CPU planes run
    ``dia_to_csr_plain``."""
    m, n = d.shape
    if d.ndiag == 0:
        return _empty(m, n, d.dtype, d.device)
    if d.device.type == "cpu":
        return dia_to_csr_plain(d, prune)
    if d.device.type != "cuda":
        raise ValueError(f"no dia_to_csr for device {d.device}")
    data = d.data
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"need float32 or float64 planes, got {data.dtype}")
    if data.shape != (d.ndiag, n):
        raise ValueError(f"planes {tuple(data.shape)} do not match "
                         f"{d.ndiag} offsets and {n} columns")
    if not data.is_contiguous():
        raise ValueError("dia_to_csr needs contiguous planes")
    p = plan(tuple(d.offsets), m, n, data.element_size(), d.device)
    dev = d.device
    rowptr = torch.empty(m + 1, dtype=INDEX_DTYPE, device=dev)
    colidx = torch.empty(p.cap, dtype=INDEX_DTYPE, device=dev)
    vals = torch.empty(p.cap, dtype=data.dtype, device=dev)
    scratch = torch.empty(p.blocks * (THREADS + 1) + 1, dtype=torch.int32,
                          device=dev)
    _build.launch("dia_to_csr", _K4_ARGS, dev, data.data_ptr(),
                  p.offsets.data_ptr(), d.ndiag, m, n, p.rows.bit_length() - 1,
                  rowptr.data_ptr(), colidx.data_ptr(), vals.data_ptr(),
                  scratch.data_ptr(), p.cap, p.window, int(prune),
                  int(data.dtype == torch.float64))
    dia_to_csr.launches += 1
    return CSR(rowptr=rowptr, colidx=colidx, vals=vals, shape=(m, n))


dia_to_csr.launches = 0
