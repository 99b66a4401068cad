"""The plain reference: sparse products, transposes and sums of CSR
matrices in PyTorch tensor operations, on whatever device the operands are.

It imports nothing of the program under test. A product expands every
(A[i,k], B[k,j]) pair, sorts the pairs by (i, j) and sums each run, in
blocks of rows so that a block's pairs stay under a budget. Every entry
keeps its structure whether or not its value sums to 0, so the result is
the structural product. Beside each value it carries ``absv``, the sum of
the absolute values of the terms behind it, which scales the error that a
rounded computation of that entry may have.

``precision="float64"`` is the reference. ``precision="bfloat16"`` is the
control: every input value rounded to bfloat16, products and sums in
float32, the step below the float32 that the configurations state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRECISIONS = ("float64", "bfloat16")


@dataclasses.dataclass
class Mat:
    """A CSR matrix with int64 structure; ``absv`` is Σ|terms| of each
    entry (for an input: its own absolute value)."""

    rowptr: torch.Tensor  # (m + 1,) int64
    colidx: torch.Tensor  # (nnz,) int64, sorted within each row
    vals: torch.Tensor  # (nnz,)
    absv: torch.Tensor  # (nnz,) float64
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.colidx.shape[0])

    def row_of(self) -> torch.Tensor:
        """The row of every entry."""
        m = self.shape[0]
        return torch.repeat_interleave(
            torch.arange(m, device=self.rowptr.device),
            self.rowptr[1:] - self.rowptr[:-1])


def from_arrays(rowptr, colidx, vals, shape, device) -> Mat:
    """A reference matrix from CSR arrays (numpy or tensors) in canonical
    order; only the first ``rowptr[-1]`` entries of colidx and vals count.
    Values are held in float64."""
    rowptr = torch.as_tensor(np.asarray(rowptr) if not torch.is_tensor(rowptr)
                             else rowptr).to(device=device, dtype=torch.int64)
    nnz = int(rowptr[-1])
    colidx = torch.as_tensor(colidx)[:nnz].to(device=device,
                                              dtype=torch.int64)
    vals = torch.as_tensor(vals)[:nnz].to(device=device, dtype=torch.float64)
    return Mat(rowptr, colidx, vals, vals.abs(), (int(shape[0]),
                                                  int(shape[1])))


def _rounded(vals: torch.Tensor, precision: str) -> torch.Tensor:
    """The values as the given precision computes with them."""
    if precision == "float64":
        return vals.to(torch.float64)
    if precision == "bfloat16":
        return vals.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def _rows_of_entries(rowptr: torch.Tensor, e0: int, e1: int) -> torch.Tensor:
    """The row of each entry e0 <= e < e1."""
    e = torch.arange(e0, e1, device=rowptr.device)
    return torch.searchsorted(rowptr, e, right=True) - 1


def _from_keys(key, vals, absv, shape) -> Mat:
    """A matrix from unique sorted keys row * n + col."""
    m, n = shape
    row = torch.div(key, n, rounding_mode="floor")
    counts = torch.bincount(row, minlength=m)
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return Mat(rowptr, key - row * n, vals, absv, (m, n))


def _sum_runs(key, vals, absv):
    """Sort by key and sum every run of equal keys."""
    key, order = torch.sort(key)
    ukey, inverse = torch.unique_consecutive(key, return_inverse=True)
    out = torch.zeros(ukey.shape[0], dtype=vals.dtype, device=key.device)
    out.index_add_(0, inverse, vals[order])
    out_abs = torch.zeros(ukey.shape[0], dtype=torch.float64,
                          device=key.device)
    out_abs.index_add_(0, inverse, absv[order])
    return ukey, out, out_abs


def row_blocks(row_work: np.ndarray, budget: int) -> list:
    """Split rows into consecutive blocks [r0, r1) whose work adds up to at
    most ``budget`` (a row that alone exceeds it is a block of its own)."""
    ends = np.cumsum(row_work, dtype=np.int64)
    blocks, r0, m = [], 0, len(row_work)
    while r0 < m:
        base = ends[r0 - 1] if r0 else 0
        r1 = int(np.searchsorted(ends, base + budget, side="right"))
        r1 = max(r1, r0 + 1)
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def spgemm(a: Mat, b: Mat, precision: str = "float64",
           budget: int = 1 << 25) -> tuple[Mat, int]:
    """(C, nnzCt): the structural product C = A @ B and its number of
    intermediate products, in blocks of rows of at most ``budget``
    products each."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    dev = a.rowptr.device
    lens = b.rowptr[a.colidx + 1] - b.rowptr[a.colidx]  # products an entry
    ends = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    row_work = ends[a.rowptr[1:]] - ends[a.rowptr[:-1]]
    total = int(ends[-1])
    a_vals = _rounded(a.vals, precision)
    b_vals = _rounded(b.vals, precision)
    keys, vals, absv = [], [], []
    rowptr_h = a.rowptr.cpu().numpy()
    for r0, r1 in row_blocks(row_work.cpu().numpy(), budget):
        e0, e1 = int(rowptr_h[r0]), int(rowptr_h[r1])
        blens = lens[e0:e1]
        if e1 == e0 or int(blens.sum()) == 0:
            continue
        eid = torch.repeat_interleave(torch.arange(e0, e1, device=dev),
                                      blens)
        starts = torch.cumsum(blens, 0) - blens
        pos = torch.arange(eid.shape[0], device=dev) - starts[eid - e0]
        bidx = b.rowptr[a.colidx[eid]] + pos
        row = _rows_of_entries(a.rowptr, e0, e1)[eid - e0]
        key = row * n + b.colidx[bidx]
        kk, vv, aa = _sum_runs(key, a_vals[eid] * b_vals[bidx],
                               a.absv[eid] * b.absv[bidx])
        keys.append(kk)
        vals.append(vv)
        absv.append(aa)
    dtype = a_vals.dtype
    if not keys:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return _from_keys(empty, empty.to(dtype), empty.double(),
                          (m, n)), total
    return _from_keys(torch.cat(keys), torch.cat(vals), torch.cat(absv),
                      (m, n)), total


def transpose(a: Mat) -> Mat:
    m, n = a.shape
    key = a.colidx * m + a.row_of()
    key, order = torch.sort(key)
    return _from_keys(key, a.vals[order], a.absv[order], (n, m))


def add(a: Mat, b: Mat, alpha: float, beta: float,
        drop_zeros: bool = False) -> Mat:
    """alpha·A + beta·B on the union of the structures; ``drop_zeros``
    removes entries whose value sums to exactly 0."""
    if a.shape != b.shape:
        raise ValueError(f"shapes {a.shape} and {b.shape}")
    n = a.shape[1]
    key = torch.cat([a.row_of() * n + a.colidx, b.row_of() * n + b.colidx])
    vals = torch.cat([alpha * a.vals, beta * b.vals])
    absv = torch.cat([abs(alpha) * a.absv, abs(beta) * b.absv])
    key, vals, absv = _sum_runs(key, vals, absv)
    if drop_zeros:
        keep = vals != 0
        key, vals, absv = key[keep], vals[keep], absv[keep]
    return _from_keys(key, vals, absv, a.shape)


def scale_rows(a: Mat, s: torch.Tensor) -> Mat:
    """diag(s) · A."""
    row = a.row_of()
    return Mat(a.rowptr, a.colidx, s[row] * a.vals, (s.abs()[row]) * a.absv,
               a.shape)


def diagonal(a: Mat) -> torch.Tensor:
    """The diagonal of A (0 where a row stores none)."""
    row = a.row_of()
    on = a.colidx == row
    d = torch.zeros(a.shape[0], dtype=a.vals.dtype, device=a.vals.device)
    d.index_add_(0, row[on], a.vals[on])
    return d
