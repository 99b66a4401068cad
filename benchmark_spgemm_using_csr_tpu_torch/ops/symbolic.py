"""Stage 1 — symbolic pass: per-row intermediate-product upper bounds.

For each row i of C, ``nnzCt[i] = sum_{j in cols(A[i,:])} nnz(B[j,:])``:
a gather of B's row lengths at A's column indices followed by a segment
sum over A's row ids. ``2 * sum(nnzCt)`` is the canonical flop count used
for GFlops. All results are integers and equal the reference package's.

The exact per-row nnz(C) is ``nnz_rows``: kernel K5
(``csrc/symbolic_count.cu``) on the card, its plain version ``nnz_exact``
on the CPU. ``exact_nnz_c`` is the host plans' one count of nnz(C).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sparse.csr import CSR, INDEX_DTYPE, host_view, pad_bucket
from ..utils import profiling
from . import _build
from .stream import gather_products, products_per_nz

# K5's entry point's arguments before the stream
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_K5_ARGS = (_P, _P, _P, _P, _LL, _LL, _P, _P, _P, _LL)
# K5's long rows keep a bitmap of n bits in shared memory while its words
# fit an sm_90 block's 232,448 bytes beside the kernel's 3 KB scan and 1 KB
# of static memory (csrc/symbolic_count.cu); past that a slice of a global
# bitmap a block, all slices at most MAP_BYTES_MAX
MAP_SMEM_BYTES = 232448 - 3072 - 1024
MAP_BYTES_MAX = 256 << 20


def nnz_upper_bound(a: CSR, b: CSR) -> torch.Tensor:
    """Per-row intermediate-product count nnzCt, shape (m,) int32."""
    per_nz = products_per_nz(a, b)
    out = torch.zeros(a.m + 1, dtype=torch.int64, device=a.device)
    out.index_add_(0, a.row_ids().long(), per_nz.long())
    return out[: a.m].to(INDEX_DTYPE)


def total_products(a: CSR, b: CSR) -> torch.Tensor:
    """Total intermediate products (== flops / 2), a 0-d int64 tensor."""
    return products_per_nz(a, b).sum(dtype=torch.int64)


def flops(a: CSR, b: CSR) -> torch.Tensor:
    """Canonical SpGEMM flop count: one mul + one add per product."""
    return 2 * total_products(a, b)


def nnz_exact(a: CSR, b: CSR, prod_capacity: int) -> torch.Tensor:
    """Exact per-row nnz(C): materialize the (row, col) product keys
    (values untouched), sort, and count unique keys per row. The plain
    version of K5 (``nnz_rows``)."""
    m = a.m
    total = total_products(a, b)
    p = torch.arange(prod_capacity, dtype=torch.int64, device=a.device)
    valid = p < total
    src_c, col, _ = gather_products(a, b, torch.where(valid, p, 0), valid)
    row = torch.where(valid, a.row_ids().long()[src_c], m)
    key = torch.sort(row * max(b.n, 1) + col).values
    row = torch.div(key, max(b.n, 1), rounding_mode="floor")
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    is_head = (row < m) & (key != prev)
    out = torch.zeros(m + 1, dtype=torch.int64, device=a.device)
    out.index_add_(0, row, is_head.long())
    return out[:m].to(INDEX_DTYPE)


def nnz_rows(a: CSR, b: CSR) -> torch.Tensor:
    """Exact per-row structural nnz(C) of C = A @ B, shape (m,) int32: the
    distinct columns of B's stored entries in the rows that A's stored
    entries name. Values are never read, so stored zeros count. CUDA
    operands run kernel K5 (``csrc/symbolic_count.cu``, built with nvcc for
    sm_90a at first use: one call, three launches on the current stream,
    nothing read back to the host); CPU operands run ``nnz_exact``."""
    if a.n != b.m:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    m, n = a.m, b.n
    dev = a.device
    if dev.type == "cpu":
        cap = pad_bucket(max(int(total_products(a, b)), 1))
        return nnz_exact(a, b, cap)
    if dev.type != "cuda":
        raise ValueError(f"no nnz_rows for device {dev}")
    for x in (a.rowptr, a.colidx, b.rowptr, b.colidx):
        if x.dtype != INDEX_DTYPE or not x.is_contiguous():
            raise TypeError("nnz_rows needs contiguous int32 structure")
    counts = torch.empty(m, dtype=INDEX_DTYPE, device=dev)
    scratch = torch.empty(2 * m + 2, dtype=INDEX_DTYPE, device=dev)
    words = max(-(-n // 32), 1)
    bitmap, map_words = None, 0
    if words * 4 > MAP_SMEM_BYTES:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = max(1, min(MAP_BYTES_MAX // (words * 4), m, 2 * sms))
        map_words = slices * words
        bitmap = torch.empty(map_words, dtype=INDEX_DTYPE, device=dev)
    _build.launch("symbolic_count", _K5_ARGS, dev, a.rowptr.data_ptr(),
                  a.colidx.data_ptr(), b.rowptr.data_ptr(),
                  b.colidx.data_ptr(), m, n, counts.data_ptr(),
                  scratch.data_ptr(),
                  None if bitmap is None else bitmap.data_ptr(), map_words)
    nnz_rows.launches += 1
    return counts


nnz_rows.launches = 0


def _pattern(x: CSR):
    """scipy CSR of x's stored entries, every value True."""
    import scipy.sparse as sp

    rowptr = host_view(x.rowptr)[: x.m + 1]
    nnz = int(rowptr[-1])
    return sp.csr_matrix(
        (np.ones(nnz, dtype=bool), host_view(x.colidx)[:nnz], rowptr),
        shape=x.shape)


def _pattern_product(a: CSR, b: CSR):
    """scipy's product of the stored entries' patterns, on the host."""
    pat_a = _pattern(a)
    return pat_a @ (pat_a if b is a else _pattern(b))


def exact_nnz_rows(a: CSR, b: CSR) -> np.ndarray:
    """The exact structural nnz of every row of C = A @ B, on the host
    (int64), as the chunked plan's row-local route needs it (span
    ``plan.nnz_c``). On the card: K5's counts copied back once (counter
    ``plan.nnz_c.device`` and one ``host.syncs``). On the CPU: the row
    lengths of scipy's pattern product."""
    with profiling.span("plan.nnz_c"):
        if a.device.type == "cuda":
            counts = nnz_rows(a, b).cpu()
            profiling.count("plan.nnz_c.device")
            profiling.count("host.syncs")
            return counts.numpy().astype(np.int64)
        return np.diff(_pattern_product(a, b).indptr).astype(np.int64)


def exact_nnz_c(a: CSR, b: CSR) -> int:
    """The exact structural nnz(C) of C = A @ B, as the host plans need it
    (span ``plan.nnz_c``). On the card: K5's per-row counts summed on the
    device and read back in one 8-byte copy (counter ``plan.nnz_c.device``
    and one ``host.syncs``). On the CPU: scipy's pattern product over the
    stored entries, faster there than ``nnz_exact``. Both count stored
    zeros, as the ESC numeric phases keep every structural product."""
    with profiling.span("plan.nnz_c"):
        if a.device.type == "cuda":
            total = nnz_rows(a, b).sum(dtype=torch.int64)
            profiling.count("plan.nnz_c.device")
            profiling.count("host.syncs")
            return int(total)
        return int(_pattern_product(a, b).nnz)
