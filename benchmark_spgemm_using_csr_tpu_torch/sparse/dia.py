"""DIA (diagonal) sparse container for stencil / banded matrices.

Storage convention (``scipy.sparse.dia_matrix``'s, and the reference
package's ``sparse/dia.py``): ``data[s, j]`` holds entry
``M[j - offsets[s], j]``, column-indexed planes of width n; ``offsets`` is a
sorted tuple of Python ints. Invariant: plane slots outside the matrix (row
out of range) are exactly 0, so the products never need masks.

The constructors take an explicit ``device``; ``to_csr`` builds the CSR on
the planes' device (kernel K4 for CUDA planes, ``ops/dia_convert``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops import dia_convert
from ..utils import profiling
from .csr import CSR, host_view, sorted_unique

Shape = Tuple[int, int]


def _outside(offsets: np.ndarray, m: int, n: int) -> np.ndarray:
    """(ndiag, n) bool: slot (s, j) lies outside the matrix (row
    ``j - offsets[s]`` not in [0, m))."""
    row = np.arange(n)[None, :] - offsets[:, None]
    return (row < 0) | (row >= m)


def _entry_diagonals(a: CSR):
    """Host (cols, col - row) of every stored entry of ``a``, CSR order."""
    rowptr = host_view(a.rowptr).astype(np.int64)
    rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(rowptr))
    cols = host_view(a.colidx)[:int(rowptr[-1])].astype(np.int64)
    return cols, cols - rows


def dia_offsets_of(a: CSR) -> np.ndarray:
    """The occupied diagonals of a CSR matrix, sorted (host, plan time)."""
    return sorted_unique(_entry_diagonals(a)[1])


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal-storage matrix of shape ``shape=(m, n)``.

    data:    (ndiag, n) value planes, column-indexed (scipy convention).
    offsets: tuple of diagonal offsets (col - row), sorted ascending.
    """

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Shape

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> np.ndarray:
        """(ndiag, n) bool: slot (s, j) is inside the matrix."""
        return ~_outside(np.asarray(self.offsets, np.int64), self.m, self.n)

    # ---- conversions -----------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        data = self.data.detach().cpu().numpy()
        return sp.dia_matrix((data, np.asarray(self.offsets)), shape=self.shape)

    def to_csr(self, prune: bool = True) -> CSR:
        """CSR on the planes' device (``ops/dia_convert.dia_to_csr``:
        kernel K4 for CUDA planes, its plain version for CPU ones), at the
        capacity ``pad_bucket`` of the in-matrix slot count. ``prune``
        drops slots that hold exactly 0 (DIA planes over-approximate the
        structure); without it every in-matrix slot is kept."""
        with profiling.span("dia.to_csr"):
            return dia_convert.dia_to_csr(self, prune)

    @staticmethod
    def from_numpy(data: np.ndarray, offsets, shape, *, device) -> "DIA":
        """DIA from host planes already sorted by offset; slots outside the
        matrix are zeroed (the invariant)."""
        offs = np.asarray(offsets, np.int64)
        data = np.array(data, order="C")
        data[_outside(offs, shape[0], shape[1])] = 0
        return DIA(torch.from_numpy(data).to(device),
                   tuple(int(o) for o in offs), (int(shape[0]), int(shape[1])))

    @staticmethod
    def from_scipy(mat, dtype=None, *, device) -> "DIA":
        mat = mat.todia()
        m, n = mat.shape
        offsets = np.asarray(mat.offsets, dtype=np.int64)
        order = np.argsort(offsets)
        offsets = offsets[order]
        src = np.asarray(mat.data)[order]
        data = np.zeros((len(offsets), n), np.dtype(dtype or src.dtype))
        w = min(src.shape[1], n)
        # scipy may leave garbage in out-of-range slots: from_numpy zeroes
        data[:, :w] = src[:, :w]
        return DIA.from_numpy(data, offsets, (m, n), device=device)

    @staticmethod
    def from_csr(a: CSR, offsets=None, dtype=None, *, device) -> "DIA":
        """CSR -> DIA. ``offsets`` defaults to the set of occupied
        diagonals; an entry off the given diagonals is a ``ValueError``.
        bfloat16 values give float32 planes (exactly; ``host_view``).
        The slots are looked up vectorised (``np.searchsorted``) on the
        host copy of the structure."""
        m, n = a.shape
        cols, occ = _entry_diagonals(a)
        vals = host_view(a.vals)[:len(cols)]
        if offsets is None:
            offsets = sorted_unique(occ)  # dia_offsets_of(a), no 2nd pass
        else:
            offsets = np.asarray(sorted(offsets), dtype=np.int64)
        slots = np.searchsorted(offsets, occ)
        off_grid = slots >= len(offsets)
        off_grid[~off_grid] = offsets[slots[~off_grid]] != occ[~off_grid]
        if off_grid.any():
            bad = int(occ[np.argmax(off_grid)])
            raise ValueError(f"entry on diagonal {bad} not in offsets")
        data = np.zeros((len(offsets), n), np.dtype(dtype or vals.dtype))
        data[slots, cols] = vals
        return DIA(torch.from_numpy(data).to(device),
                   tuple(int(o) for o in offsets), (m, n))
