"""Sparse matrix containers: CSR / COO / BSR as frozen dataclasses of torch
tensors.

The conventions are those of ``benchmark_spgemm_using_csr_tpu.sparse.csr``,
so buffers of the two packages compare directly:

- ``rowptr`` is exact: ``rowptr[-1] == nnz``;
- ``colidx``/``vals`` are padded to a growth bucket (``pad_bucket``) and
  hold 0 past nnz, so they are always safe to gather through;
- padding slots map to the virtual row ``m`` (``row_ids``).

Every function works on the device of the tensors it is given; the
constructors that make tensors from host arrays take an explicit
``device``. Buffers are treated as immutable: nothing here writes into a
tensor it was given.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Tuple

import numpy as np
import torch

from ..utils import profiling

Shape = Tuple[int, int]

INDEX_DTYPE = torch.int32


def _version(t: torch.Tensor):
    """torch's count of in-place writes to ``t`` (None for an inference
    tensor, which keeps no count)."""
    try:
        return t._version
    except RuntimeError:
        return None


class IdentityMemo:
    """A bounded memo keyed by the identity of tensors (plus hashable
    extras) that holds each keyed tensor weakly. An entry leaves when one
    of its tensors is collected, so a recycled ``id()`` never finds another
    tensor's entry and the memo keeps no tensor alive. An entry misses once
    one of its tensors has been written in place since it was stored
    (torch's version counter), so a value derived from the old contents is
    never returned. Past ``cap`` entries the least recently used one
    leaves."""

    def __init__(self, cap: int):
        self.cap = cap
        # key -> (value, weak references to the keyed tensors, versions)
        self._entries: dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def get(self, tensors, extra=()):
        """The value stored for these very tensors (and extras), or None."""
        key = tuple(id(t) for t in tensors) + tuple(extra)
        hit = self._entries.pop(key, None)
        if hit is None or any(r() is not t for r, t in zip(hit[1], tensors)):
            return None
        if hit[2] != tuple(_version(t) for t in tensors):
            return None  # written in place since: the entry is stale
        self._entries[key] = hit  # most recently used last
        return hit[0]

    def put(self, tensors, extra, value):
        key = tuple(id(t) for t in tensors) + tuple(extra)
        self._entries.pop(key, None)
        while len(self._entries) >= self.cap:
            self._entries.pop(next(iter(self._entries)))
        forget = functools.partial(self._forget, key)
        self._entries[key] = (value, tuple(weakref.ref(t, forget)
                                           for t in tensors),
                              tuple(_version(t) for t in tensors))
        return value

    def _forget(self, key, ref) -> None:
        """A weak reference's callback: drop the entry of a collected
        tensor (unless the key already names a newer entry)."""
        hit = self._entries.get(key)
        if hit is not None and any(r is ref for r in hit[1]):
            del self._entries[key]


# device tensor -> its host array; 256 entries bound the host memory held
_HOST_MIRROR = IdentityMemo(256)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array; bfloat16 comes as float32
    (exactly: numpy has no bfloat16)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def host_view(x) -> np.ndarray:
    """Host numpy view of a possibly-device tensor (bfloat16 as float32),
    memoized for device tensors. Plan construction reads the same CSR
    buffers many times; on CUDA each uncached call is a device->host copy
    and a sync. The memo holds each tensor weakly (``IdentityMemo``), so
    it keeps no device memory alive."""
    if isinstance(x, np.ndarray):
        return x
    if x.device.type == "cpu":
        return _to_numpy(x)
    hit = _HOST_MIRROR.get((x,))
    if hit is not None:
        return hit
    with profiling.span("host.copy"):
        profiling.count("host.syncs")
        v = _to_numpy(x)
    profiling.count("host.d2h_bytes", v.nbytes)
    _remember_host(x, v)
    return v


def _remember_host(dev, host) -> None:
    """Pre-populate the host mirror when the host already has the data."""
    if dev.device.type != "cpu":
        _HOST_MIRROR.put((dev,), (), host)


def clear_host_mirror() -> None:
    """Drop every memoized host view (for tests)."""
    _HOST_MIRROR.clear()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type products of ``dtype`` values are formed and summed in:
    float32 for bfloat16 and float16 (as the reference package does on its
    sort-based paths), the type itself otherwise."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1). Used for growth-bucket padding."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def pad_bucket(n: int, minimum: int = 8) -> int:
    """Padding bucket policy: power-of-two growth buckets."""
    return max(next_pow2(n), minimum)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row matrix of shape ``shape=(m, n)``.

    rowptr: (m+1,) int32, exact: rowptr[-1] == nnz.
    colidx: (capacity,) int32, entries [nnz:] are 0 (padding).
    vals:   (capacity,) float dtype, entries [nnz:] are 0 (padding).
    """

    rowptr: torch.Tensor
    colidx: torch.Tensor
    vals: torch.Tensor
    shape: Shape

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.colidx.shape[0]

    @property
    def nnz(self) -> torch.Tensor:
        """Exact number of stored entries (a 0-d tensor on the device)."""
        return self.rowptr[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.rowptr.device

    def row_lengths(self) -> torch.Tensor:
        return self.rowptr[1:] - self.rowptr[:-1]

    def row_ids(self) -> torch.Tensor:
        """Row id of every slot in colidx/vals; padding slots map to ``m``."""
        return row_ids_from_rowptr(self.rowptr, self.capacity)

    # ---- conversions -----------------------------------------------------
    def to_scipy(self):
        """scipy CSR copy (bfloat16 values as float32, exactly: scipy and
        numpy have no bfloat16)."""
        import scipy.sparse as sp

        rowptr = host_view(self.rowptr).copy()
        nnz = int(rowptr[-1])
        return sp.csr_matrix(
            (
                host_view(self.vals)[:nnz].copy(),
                host_view(self.colidx)[:nnz].copy(),
                rowptr,
            ),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(mat, capacity: int | None = None, dtype=None, *,
                   device) -> "CSR":
        mat = mat.tocsr()
        mat.sort_indices()
        nnz = mat.nnz
        cap = capacity if capacity is not None else pad_bucket(nnz)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        # a torch dtype (bfloat16 too: numpy has none) rounds the values
        # on their way to the tensor; a numpy dtype converts them here
        vals_dtype = dtype if isinstance(dtype, torch.dtype) else None
        if vals_dtype is not None:
            dtype = np.float64 if vals_dtype == torch.float64 else np.float32
        dtype = np.dtype(dtype) if dtype is not None else mat.data.dtype
        colidx = np.zeros(cap, np.int32)
        vals = np.zeros(cap, dtype)
        colidx[:nnz] = mat.indices
        vals[:nnz] = mat.data
        rowptr = np.asarray(mat.indptr, np.int32)
        return CSR.from_numpy(rowptr, colidx, vals, tuple(mat.shape),
                              device=device, dtype=vals_dtype)

    @staticmethod
    def from_numpy(rowptr, colidx, vals, shape, *, device,
                   dtype: torch.dtype | None = None) -> "CSR":
        """CSR from host buffers that already follow the conventions (the
        bridge from the reference package: ``np.asarray`` of its buffers).
        ``dtype``, a torch dtype, converts the values (default: their own
        type)."""
        # private copies: the tensors (on the CPU) and the host mirror
        # must not alias arrays the caller may change
        rowptr = np.array(rowptr, np.int32, order="C")
        colidx = np.array(colidx, np.int32, order="C")
        vals = np.array(vals, order="C")
        if rowptr.shape != (shape[0] + 1,):
            raise ValueError(f"rowptr shape {rowptr.shape} != ({shape[0] + 1},)")
        if colidx.shape != vals.shape:
            raise ValueError(f"colidx {colidx.shape} != vals {vals.shape}")
        vals_t = torch.from_numpy(vals)
        if dtype is not None and dtype != vals_t.dtype:
            vals_t = vals_t.to(dtype)
            vals = _to_numpy(vals_t)  # the mirror holds the rounded values
        out = CSR(
            rowptr=_to_device(rowptr, device),
            colidx=_to_device(colidx, device),
            vals=vals_t.to(device),
            shape=(int(shape[0]), int(shape[1])),
        )
        # the host already HAS these arrays: mirror them so plans
        # never pay a device->host copy
        _remember_host(out.rowptr, rowptr)
        _remember_host(out.colidx, colidx)
        _remember_host(out.vals, vals)
        return out

    @staticmethod
    def from_dense(arr, capacity: int | None = None, *, device) -> "CSR":
        import scipy.sparse as sp

        return CSR.from_scipy(sp.csr_matrix(np.asarray(arr)), capacity,
                              device=device)

    def todense(self) -> np.ndarray:
        return np.asarray(self.to_scipy().todense())

    # ---- persistence: the reference package's npz layout, so a file
    # either package saves loads in the other --------------------------------
    def save(self, path: str) -> None:
        np.savez(
            path,
            rowptr=host_view(self.rowptr),
            colidx=host_view(self.colidx),
            vals=host_view(self.vals),
            shape=np.asarray(self.shape),
        )

    @staticmethod
    def load(path: str, *, device) -> "CSR":
        with np.load(path) as z:
            return CSR.from_numpy(z["rowptr"], z["colidx"], z["vals"],
                                  tuple(int(s) for s in z["shape"]),
                                  device=device)

    def to_numpy(self):
        """(rowptr, colidx, vals) as host numpy copies."""
        return (
            host_view(self.rowptr).copy(),
            host_view(self.colidx).copy(),
            host_view(self.vals).copy(),
        )

    def to_coo(self) -> "COO":
        return COO(
            row=self.row_ids().to(INDEX_DTYPE),
            col=self.colidx,
            vals=self.vals,
            shape=self.shape,
        )

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow/shrink the padded buffers (one device->host read of nnz)."""
        profiling.count("host.syncs")
        nnz = int(self.rowptr[-1])
        if capacity < nnz:
            raise ValueError(f"capacity {capacity} < nnz {nnz}")
        colidx = torch.zeros(capacity, dtype=INDEX_DTYPE, device=self.device)
        vals = torch.zeros(capacity, dtype=self.vals.dtype, device=self.device)
        colidx[:nnz] = self.colidx[:nnz]
        vals[:nnz] = self.vals[:nnz]
        return CSR(self.rowptr, colidx, vals, self.shape)

    def validate(self) -> "CSR":
        """Host-side structural validation with precise errors. Returns
        self for chaining."""
        rowptr = host_view(self.rowptr)
        colidx = host_view(self.colidx)
        m, n = self.shape
        if rowptr.shape != (m + 1,):
            raise ValueError(f"rowptr shape {rowptr.shape} != ({m + 1},)")
        if rowptr[0] != 0:
            raise ValueError(f"rowptr[0] = {rowptr[0]} != 0")
        if (np.diff(rowptr) < 0).any():
            bad = int(np.argmax(np.diff(rowptr) < 0))
            raise ValueError(f"rowptr not non-decreasing at row {bad}")
        nnz = int(rowptr[-1])
        if nnz > self.capacity:
            raise ValueError(f"nnz {nnz} exceeds capacity {self.capacity}")
        if nnz and (colidx[:nnz] < 0).any():
            raise ValueError("negative column index")
        if nnz and (colidx[:nnz] >= n).any():
            bad = int(np.argmax(colidx[:nnz] >= n))
            raise ValueError(
                f"colidx[{bad}] = {colidx[bad]} out of range for n = {n}"
            )
        if self.vals.shape != self.colidx.shape:
            raise ValueError(
                f"vals shape {self.vals.shape} != colidx shape {self.colidx.shape}"
            )
        return self


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format matrix; padding entries have row == m (sentinel)."""

    row: torch.Tensor
    col: torch.Tensor
    vals: torch.Tensor
    shape: Shape

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    def to_csr(self, sort: bool = True, sum_duplicates: bool = False) -> CSR:
        return coo_to_csr(self, sort=sort, sum_duplicates=sum_duplicates)

    @staticmethod
    def from_arrays(row, col, vals, shape, capacity: int | None = None, *,
                    device) -> "COO":
        row = np.asarray(row)
        col = np.asarray(col)
        vals = np.asarray(vals)
        nnz = row.shape[0]
        cap = capacity if capacity is not None else pad_bucket(nnz)
        m = shape[0]
        r = np.full(cap, m, np.int32)
        c = np.zeros(cap, np.int32)
        v = np.zeros(cap, vals.dtype)
        r[:nnz] = row
        c[:nnz] = col
        v[:nnz] = vals
        return COO(_to_device(r, device), _to_device(c, device),
                   _to_device(v, device), tuple(shape))


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block CSR with dense (bm, bn) blocks.

    blocks: (nblocks_capacity, bm, bn) dense value blocks, zero past nnzb.
    rowptr/colidx index *block* rows/cols. Shape is in scalar elements and
    must be divisible by the block size.
    """

    rowptr: torch.Tensor
    colidx: torch.Tensor
    blocks: torch.Tensor
    shape: Shape

    @property
    def block_shape(self) -> Shape:
        return tuple(self.blocks.shape[1:])

    @property
    def mb(self) -> int:
        return self.shape[0] // self.blocks.shape[1]

    @property
    def nb(self) -> int:
        return self.shape[1] // self.blocks.shape[2]

    @property
    def nnzb(self) -> torch.Tensor:
        return self.rowptr[-1]

    @property
    def device(self) -> torch.device:
        return self.rowptr.device

    def to_scipy(self):
        import scipy.sparse as sp

        rowptr = host_view(self.rowptr).copy()
        nnzb = int(rowptr[-1])
        return sp.bsr_matrix(
            (host_view(self.blocks)[:nnzb].copy(),
             host_view(self.colidx)[:nnzb].copy(), rowptr),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(mat, block_shape=(8, 128), capacity: int | None = None,
                   *, device) -> "BSR":
        import scipy.sparse as sp

        bm, bn = block_shape
        mat = sp.bsr_matrix(mat.tocsr(), blocksize=(bm, bn))
        nnzb = mat.indptr[-1]
        cap = capacity if capacity is not None else pad_bucket(max(nnzb, 1))
        blocks = np.zeros((cap, bm, bn), mat.data.dtype)
        colidx = np.zeros(cap, np.int32)
        blocks[:nnzb] = mat.data
        colidx[:nnzb] = mat.indices
        return BSR.from_numpy(mat.indptr, colidx, blocks, tuple(mat.shape),
                              device=device)

    @staticmethod
    def from_numpy(rowptr, colidx, blocks, shape, *, device) -> "BSR":
        """BSR from host buffers that already follow the conventions (the
        bridge from the reference package: ``np.asarray`` of its buffers)."""
        rowptr = np.array(rowptr, np.int32, order="C")
        colidx = np.array(colidx, np.int32, order="C")
        blocks = np.array(blocks, order="C")
        if blocks.ndim != 3 or colidx.shape != blocks.shape[:1]:
            raise ValueError(f"colidx {colidx.shape} != blocks "
                             f"{blocks.shape[:1]} (blocks must be 3-d)")
        out = BSR(
            rowptr=_to_device(rowptr, device),
            colidx=_to_device(colidx, device),
            blocks=_to_device(blocks, device),
            shape=(int(shape[0]), int(shape[1])),
        )
        _remember_host(out.rowptr, rowptr)
        _remember_host(out.colidx, colidx)
        _remember_host(out.blocks, blocks)
        return out

    def to_csr(self, capacity: int | None = None) -> CSR:
        return CSR.from_scipy(self.to_scipy().tocsr(), capacity,
                              device=self.device)


# ---------------------------------------------------------------------------
# Structural helpers shared by the whole package
# ---------------------------------------------------------------------------


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D host array: one sort and a neighbour compare.
    NumPy 2.3's ``np.unique`` builds a hash table first, which on arrays of
    many distinct keys takes many times as long as the sort (chip_smoke.py
    prints both on er_medium's block keys)."""
    s = np.sort(x)
    keep = np.ones(s.shape, bool)
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def row_ids_from_rowptr(rowptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Expand a rowptr into per-slot row ids; slots >= nnz map to row m.

    Slot p belongs to the number of row ends <= p, which a binary search of
    the row ends gives directly (slots past nnz count every end: row m)."""
    p = torch.arange(capacity, dtype=rowptr.dtype, device=rowptr.device)
    return torch.searchsorted(rowptr[1:].contiguous(), p,
                              right=True).to(INDEX_DTYPE)


def coo_to_csr(coo: COO, sort: bool = True, sum_duplicates: bool = False) -> CSR:
    """COO->CSR on the device. Padding entries (row == m) sort to the tail
    and are excluded from rowptr by construction."""
    m, n = coo.shape
    dev = coo.row.device
    row = coo.row.to(torch.int64)
    col = coo.col.to(torch.int64)
    vals = coo.vals
    if sort:
        order = torch.sort(row * max(n, 1) + col).indices
        row, col, vals = row[order], col[order], vals[order]
    cap = row.shape[0]
    if sum_duplicates:
        valid = row < m
        prev_row = torch.cat([row.new_full((1,), -1), row[:-1]])
        prev_col = torch.cat([col.new_full((1,), -1), col[:-1]])
        is_head = (row != prev_row) | (col != prev_col)
        seg = torch.cumsum(is_head.to(torch.int64), 0) - 1
        seg_for_sum = torch.where(valid, seg, cap)
        new_vals = torch.zeros(cap + 1, dtype=vals.dtype, device=dev)
        new_vals.index_add_(0, seg_for_sum, torch.where(valid, vals, 0))
        tgt = torch.where(is_head & valid, seg, cap)
        new_row = torch.full((cap + 1,), m, dtype=torch.int64, device=dev)
        new_row[tgt] = row
        new_col = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        new_col[tgt] = col
        row, col, vals = new_row[:cap], new_col[:cap], new_vals[:cap]
    counts = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, row.clamp(max=m), torch.ones_like(row))
    rowptr = torch.cat(
        [counts.new_zeros(1), torch.cumsum(counts[:m], 0)]
    ).to(INDEX_DTYPE)
    return CSR(rowptr=rowptr, colidx=col.to(INDEX_DTYPE), vals=vals,
               shape=coo.shape)


def csr_gather_rows(a: CSR, rows: torch.Tensor, nnz_capacity: int) -> CSR:
    """The rows ``rows`` of ``a`` as a new CSR of shape (len(rows), a.n),
    with ``nnz_capacity`` slots. ``rows`` may be padded with ``a.m``: those
    become empty rows. (The long-row tail of ops/binned.)"""
    m, n = a.shape
    r = rows.shape[0]
    dev = a.device
    rows = rows.long()
    rows_c = torch.clamp(rows, max=m - 1)
    in_range = rows < m
    lens = torch.where(in_range, a.row_lengths().long()[rows_c], 0)
    starts_src = torch.where(in_range, a.rowptr.long()[rows_c], 0)
    ends = torch.cumsum(lens, 0)
    starts_dst = ends - lens
    t = torch.arange(nnz_capacity, dtype=torch.int64, device=dev)
    if r == 0:
        valid = torch.zeros_like(t, dtype=torch.bool)
        src = t
    else:
        # the output row of slot t: the first row whose end passes t (empty
        # rows share their end with the row before them)
        j = torch.clamp(torch.searchsorted(ends, t, right=True), max=r - 1)
        valid = t < ends[-1]
        src = starts_src[j] + (t - starts_dst[j])
    src_c = torch.clamp(src, 0, a.capacity - 1)
    colidx = torch.where(valid, a.colidx[src_c], 0).to(INDEX_DTYPE)
    vals = torch.where(valid, a.vals[src_c], 0)
    rowptr = torch.cat([ends.new_zeros(1), ends]).to(INDEX_DTYPE)
    return CSR(rowptr=rowptr, colidx=colidx, vals=vals, shape=(r, n))


def csr_transpose(a: CSR) -> CSR:
    """CSR transpose via a COO sort."""
    coo = a.to_coo()
    pad = coo.row >= a.m
    t = COO(
        row=torch.where(pad, a.n, coo.col).to(INDEX_DTYPE),
        col=torch.where(pad, 0, coo.row).to(INDEX_DTYPE),
        vals=torch.where(pad, torch.zeros((), dtype=a.vals.dtype,
                                          device=a.device), coo.vals),
        shape=(a.n, a.m),
    )
    return t.to_csr(sort=True)
