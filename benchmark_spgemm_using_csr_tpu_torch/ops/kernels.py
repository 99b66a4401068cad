"""Hand-written Hopper kernels of the numeric phase, with their plain
PyTorch versions.

``tile_sort_merge`` (kernel K1) replaces the reference package's Pallas
kernel ``ops/pallas_kernels.py::tile_sort_merge``; ``bin_sort_compress``
(kernel K2) replaces ``ops/pallas_kernels.py::bin_sort_compress``. The CUDA
sources are ``csrc/tile_sort_merge.cu`` and ``csrc/bin_sort_compress.cu``,
which share their sort and merge core (``csrc/sort_merge.cuh``); they are
built with nvcc for sm_90a at first use (``ops/_build.py``) and called
through ctypes on PyTorch's current stream.

Dispatch is by the device of the tensors: a CPU tensor runs the plain
version, a CUDA tensor runs the kernel or raises. There is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_WIDTH = 2048  # the widest row the kernels' launch switches instantiate
MAX_WLR = 1024  # per-local-row counters held in shared memory
# the C entry points' arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K1_ARGS = (_P,) * 6 + (_I,) * 5
_K2_ARGS = (_P,) * 6 + (_LL, _I, _I, _I)


def _sort_merge_plain(key, val, sentinel: int):
    """The plain core shared by K1 and K2, lane for lane the Pallas
    kernels: sort each row by (key, val); segmented run-sum of equal keys
    with the Pallas log-step (Hillis–Steele) addition tree, always adding,
    so -0.0 turns +0.0; run tails (last lane of a run below the sentinel)
    keep (key, sum) and their index among the row's tails, every other
    lane (sentinel, 0) and index W.
    Returns (okey, oval, pos, sorted keys, tail flags)."""
    width = key.shape[1]
    # lexicographic (key, val): stable sort by val, then stable by key
    val_s, p1 = torch.sort(val, dim=1, stable=True)
    key_s, p2 = torch.sort(torch.gather(key, 1, p1), dim=1, stable=True)
    val_s = torch.gather(val_s, 1, p2)

    run = val_s
    k = 1
    while k < width:
        same = torch.zeros_like(key_s, dtype=torch.bool)
        same[:, k:] = key_s[:, k:] == key_s[:, :-k]
        shifted = torch.zeros_like(run)
        shifted[:, k:] = run[:, :-k]
        run = run + torch.where(same, shifted, 0)
        k *= 2

    key_next = torch.full_like(key_s, sentinel)
    key_next[:, :-1] = key_s[:, 1:]
    lane = torch.arange(width, device=key.device)
    is_tail = (key_s < sentinel) & ((key_s != key_next) | (lane == width - 1))
    incl = torch.cumsum(is_tail.to(torch.int32), 1, dtype=torch.int32)
    okey = torch.where(is_tail, key_s, sentinel).to(key.dtype)
    oval = torch.where(is_tail, run, 0).to(val.dtype)
    pos = torch.where(is_tail, incl - 1, width).to(torch.int32)
    return okey, oval, pos, key_s, is_tail


def tile_sort_merge_plain(key, val, *, sentinel: int, wlr: int, cbits: int):
    """Plain PyTorch version of K1, lane for lane the Pallas contract.

    For each tile row: sort by (key, val); segmented run-sum of equal keys;
    run tails keep (key, sum), every other lane (sentinel, 0); ``pos`` = the
    tail's index among the row's tails, W where the lane is dropped;
    ``cnt[t, j]`` = tails whose ``key >> cbits == j``, for j < wlr."""
    r = key.shape[0]
    okey, oval, pos, key_s, is_tail = _sort_merge_plain(key, val, sentinel)
    lr = (key_s.long() & 0xFFFFFFFF) >> cbits  # logical shift, as Pallas
    slot = torch.where(is_tail & (lr < wlr), lr, wlr)
    cnt = torch.zeros(r, wlr + 1, dtype=torch.int32, device=key.device)
    cnt.scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.int32))
    return okey, oval, pos, cnt[:, :wlr].contiguous()


def bin_sort_compress_plain(col, val, *, n_sentinel: int):
    """Plain PyTorch version of K2, lane for lane the Pallas contract: the
    sort, merge and positions of K1 on unpacked column ids (invalid lanes
    hold ``n_sentinel``), and ``counts[row]`` = the row's number of tails,
    its exact nnz(C)."""
    ocol, oval, pos, _, is_tail = _sort_merge_plain(col, val, n_sentinel)
    return ocol, oval, pos, is_tail.sum(1, dtype=torch.int32)


def _check(key, val, sentinel: int, val_dtypes=(torch.float32,)):
    """What K1 and K2 share: (r, W) int32 keys and values of one of
    ``val_dtypes`` on one device, W a power of two >= 2, a positive int32
    sentinel."""
    if key.dim() != 2 or key.shape != val.shape:
        raise ValueError(f"key {tuple(key.shape)} / val {tuple(val.shape)}: "
                         "need equal (r, W) shapes")
    if key.dtype != torch.int32 or val.dtype not in val_dtypes:
        raise TypeError(f"need int32 keys and {val_dtypes} values, got "
                        f"{key.dtype} / {val.dtype}")
    if key.device != val.device:
        raise ValueError(f"key on {key.device}, val on {val.device}")
    width = key.shape[1]
    if width < 2 or width & (width - 1):
        raise ValueError(f"width {width} must be a power of two >= 2")
    if not 0 < sentinel < 2**31:
        raise ValueError(f"sentinel {sentinel} must be a positive int32")


def _check_cuda(key, val, name: str):
    """The kernels' own limits, for a tensor that is not on the CPU."""
    if key.device.type != "cuda":
        raise ValueError(f"no {name} for device {key.device}")
    if key.shape[1] > MAX_WIDTH:
        raise ValueError(f"width {key.shape[1]} > {MAX_WIDTH}")
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError(f"{name} needs contiguous key and val")


def tile_sort_merge(key, val, *, sentinel: int, wlr: int, cbits: int):
    """Fused sort + duplicate-merge + positions + per-local-row counts over
    a (tiles, W) packed product tile (key = local_row << cbits | col;
    invalid lanes hold ``sentinel``). W is a power of two.

    Returns (keys, vals, pos, counts): run-tail entries (merged values)
    with sentinel / 0 elsewhere; each tail's index within its tile (W =>
    drop); (tiles, wlr) tail counts per local row. CPU tensors run
    ``tile_sort_merge_plain``; CUDA tensors run the K1 kernel."""
    _check(key, val, sentinel)
    if not 1 <= wlr:
        raise ValueError(f"wlr {wlr} must be >= 1")
    if key.device.type == "cpu":
        return tile_sort_merge_plain(key, val, sentinel=sentinel, wlr=wlr,
                                     cbits=cbits)
    _check_cuda(key, val, "tile_sort_merge")
    if wlr > MAX_WLR:
        raise ValueError(f"wlr {wlr} > {MAX_WLR}")
    if not (0 <= cbits < 31):
        raise ValueError(f"cbits {cbits} out of range")
    r, width = key.shape
    okey = torch.empty_like(key)
    oval = torch.empty_like(val)
    pos = torch.empty_like(key)
    cnt = torch.empty((r, wlr), dtype=torch.int32, device=key.device)
    if r == 0:
        return okey, oval, pos, cnt
    _build.launch("tile_sort_merge", _K1_ARGS, key.device, key.data_ptr(),
                  val.data_ptr(), okey.data_ptr(), oval.data_ptr(),
                  pos.data_ptr(), cnt.data_ptr(), r, width, wlr, cbits,
                  sentinel)
    tile_sort_merge.launches += 1
    return okey, oval, pos, cnt


tile_sort_merge.launches = 0


def bin_sort_compress(col, val, *, n_sentinel: int):
    """Fused sort + duplicate-merge + positions over a (rows, W) tile of
    gathered products (column ids; invalid lanes hold ``n_sentinel``, which
    exceeds every valid column) and float32 or float64 values. W is a power
    of two.

    Returns (cols, vals, pos, counts): run-tail entries (unique columns,
    merged values) with n_sentinel / 0 elsewhere; each tail's index within
    its row (W => drop); (rows,) int32 exact nnz(C) per row. CPU tensors
    run ``bin_sort_compress_plain``; CUDA tensors run the K2 kernel."""
    _check(col, val, n_sentinel, (torch.float32, torch.float64))
    if col.device.type == "cpu":
        return bin_sort_compress_plain(col, val, n_sentinel=n_sentinel)
    _check_cuda(col, val, "bin_sort_compress")
    r, width = col.shape
    ocol = torch.empty_like(col)
    oval = torch.empty_like(val)
    pos = torch.empty_like(col)
    cnt = torch.empty((r,), dtype=torch.int32, device=col.device)
    if r == 0:
        return ocol, oval, pos, cnt
    _build.launch("bin_sort_compress", _K2_ARGS, col.device, col.data_ptr(),
                  val.data_ptr(), ocol.data_ptr(), oval.data_ptr(),
                  pos.data_ptr(), cnt.data_ptr(), r, width, n_sentinel,
                  int(val.dtype == torch.float64))
    bin_sort_compress.launches += 1
    return ocol, oval, pos, cnt


bin_sort_compress.launches = 0

