"""Kernel K6, ``rowlocal_esc``: C = A·B one row of A at a time on chip.

The chunked plan (``ops/chunked.make_chunked_plan``) takes this route
when every row of the product fits the kernel: at most ``MAX_PRODUCTS``
products, and the shared memory of its widest row (``smem_bytes``) within
half an SM's, so that two blocks share an SM (at one block an SM, K6 ran
slower than the stream on circuit_262k's rows). Then no product stream exists: each row's products are
expanded, ordered by (column, value bits), summed with the addition tree
of ``csrc/sort_merge.cuh`` and written at C's exact row offsets, which
kernel K5 (``ops/symbolic.nnz_rows``) counts on the device in the same
call. Nothing is read back to the host, so a call captures and replays
as one CUDA graph.

``rowlocal_esc`` runs K6 (``csrc/rowlocal_esc.cu``, built with nvcc for
sm_90a at first use) on CUDA tensors and the plain version
``rowlocal_esc_plain`` on CPU tensors; the kernel is bit-equal to it.
bfloat16 and float16 products are formed and summed in float32 and C is
rounded once, as K1–K3 do.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, acc_dtype
from . import _build
from .stream import F32_PACKABLE, gather_products, merge_products
from .symbolic import nnz_rows, total_products

MAX_PRODUCTS = 8192  # the widest row K6 takes
# dynamic shared memory a block may use: the opt-in 232,448 bytes of an
# sm_90 block less the kernel's static shared memory (at most 10.5 KB)
BLOCK_SMEM_MAX = 232448 - 10752
# what the plan's route allows, so that two blocks share an SM: half its
# 233,472 bytes, less the 1 KB a block reserves and the static 10.5 KB
SMEM_MAX = 233472 // 2 - 1024 - 10752
MIN_TABLE = 32  # the hash's least size (csrc/rowlocal_esc.cu)
VALUE_DTYPES = F32_PACKABLE + (torch.float64,)
# K6's entry point's arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K6_ARGS = (_P,) * 9 + (_LL, _I, _I, _I, _I)


@dataclasses.dataclass(frozen=True)
class RowLocal:
    """K6's launch for one product's structure (built on the host)."""

    smem: int  # dynamic shared memory a block, bytes: what the widest row needs
    threads: int  # threads a block, a power of two in 64..512
    slots: int  # products staged a call: every row's, unpadded


def _pow2(x: np.ndarray) -> np.ndarray:
    """Smallest power of two >= x, elementwise (x >= 1)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.left_shift(1, np.ceil(np.log2(x)).astype(np.int64))


def smem_bytes(products: np.ndarray, nnz_c: np.ndarray,
               double: bool) -> np.ndarray:
    """The shared memory each row needs in K6, bytes: the sorted columns
    (8 a power of two >= U), the hash's columns and counts (8 a power of two
    >= 4U, at least MIN_TABLE), the bucket offsets (4·(U + 1)), then, from a
    16-byte boundary, 12 bytes a product (20 in float64). U: the row's
    nnz(C)."""
    u = np.asarray(nnz_c, np.int64)
    head = 8 * _pow2(u) + 4 * (2 * _pow2(np.maximum(4 * u, MIN_TABLE))
                               + u + 1)
    head = (head + 15) // 16 * 16
    return head + np.asarray(products, np.int64) * (20 if double else 12)


def make_launch(products: np.ndarray, nnz_c: np.ndarray,
                dtype: torch.dtype) -> RowLocal | None:
    """K6's launch for rows of ``products`` products and ``nnz_c``
    distinct columns each, or None where a row does not fit the kernel:
    more than MAX_PRODUCTS products, or more shared memory than a block
    has (BLOCK_SMEM_MAX). The plan takes the route only where the launch
    also leaves room for two blocks an SM (SMEM_MAX)."""
    products = np.asarray(products, np.int64)
    if dtype not in VALUE_DTYPES or products.size == 0:
        return None
    p_max = int(products.max())
    if p_max > MAX_PRODUCTS:
        return None
    smem = int(smem_bytes(products, nnz_c, dtype == torch.float64).max())
    if smem > BLOCK_SMEM_MAX:
        return None
    # a thread for every 16 products of the widest row, within 64..512
    threads = int(min(max(_pow2(-(-p_max // 16)), 64), 512))
    return RowLocal(smem=smem, threads=threads, slots=int(products.sum()))


def order_bits(val: torch.Tensor) -> torch.Tensor:
    """int64 keys that order float32 or float64 values as K6 does: by their
    bits, -0.0 below +0.0 (``SortVal`` of ``csrc/sort_merge.cuh``)."""
    if val.dtype == torch.float64:
        b = val.view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    b = val.view(torch.int32).long()
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def rowlocal_esc_plain(a: CSR, b: CSR, *, out_cap: int,
                       max_run: int) -> CSR:
    """Plain PyTorch version of K6, entry for entry: every product a·b
    (in ``acc_dtype``), ordered by (row, column, value bits), the runs of
    equal (row, column) summed with the Hillis–Steele passes k = 1, 2, 4,
    ... < max_run, each lane adding lane i-k's partial where it lies in the
    run, else +0.0; C's columns and sums at capacity ``out_cap``."""
    total = int(total_products(a, b))
    cap = max(total, max_run, 1)
    p = torch.arange(cap, dtype=torch.int64, device=a.device)
    valid = p < total
    src, col, val = gather_products(a, b, torch.where(valid, p, 0), valid)
    row = torch.where(valid, a.row_ids().long()[src], a.m)
    return merge_products(row, col, val, a.m, b.n, out_cap, max_run,
                          a.vals.dtype, by_value=order_bits(val))


def rowlocal_esc(a: CSR, b: CSR, route: RowLocal, *, out_cap: int,
                 max_run: int) -> CSR:
    """C = A @ B at capacity ``out_cap`` (at least nnz(C)) through K6 and
    ``route``, its launch; ``max_run`` bounds every (row, column)'s count
    of products (``ChunkedPlan.max_run``). CPU tensors run
    ``rowlocal_esc_plain``; CUDA tensors run K5 for C's rowptr, then K6: two
    launches on the current stream, nothing read back to the host."""
    if a.n != b.m:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.vals.dtype != b.vals.dtype or a.vals.dtype not in VALUE_DTYPES:
        raise TypeError(f"K6 takes one of {VALUE_DTYPES}, got "
                        f"{a.vals.dtype} / {b.vals.dtype}")
    dev = a.device
    if dev.type == "cpu":
        return rowlocal_esc_plain(a, b, out_cap=out_cap, max_run=max_run)
    if dev.type != "cuda":
        raise ValueError(f"no rowlocal_esc for device {dev}")
    m = a.m
    acc = acc_dtype(a.vals.dtype)
    av = a.vals.to(acc).contiguous()
    bv = av if b is a else b.vals.to(acc).contiguous()
    rowptr = torch.zeros(m + 1, dtype=INDEX_DTYPE, device=dev)
    torch.cumsum(nnz_rows(a, b), 0, dtype=INDEX_DTYPE, out=rowptr[1:])
    colidx = torch.zeros(out_cap, dtype=INDEX_DTYPE, device=dev)
    vals = torch.zeros(out_cap, dtype=acc, device=dev)
    _build.launch("rowlocal_esc", _K6_ARGS, dev, a.rowptr.data_ptr(),
                  a.colidx.data_ptr(), av.data_ptr(), b.rowptr.data_ptr(),
                  b.colidx.data_ptr(), bv.data_ptr(), rowptr.data_ptr(),
                  colidx.data_ptr(), vals.data_ptr(), m, route.threads,
                  route.smem, max_run, int(acc == torch.float64))
    rowlocal_esc.launches += 1
    return CSR(rowptr=rowptr, colidx=colidx, vals=vals.to(a.vals.dtype),
               shape=(m, b.n))


rowlocal_esc.launches = 0
