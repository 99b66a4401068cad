"""The comparison that decides ``correct``: a CSR that the program produced
against the reference's.

Two numbers, each with a limit of its own (``limits/<cell>.json``):

- ``struct_mismatch``: how many row lengths differ, or, where every row
  has the reference's length, how many column indices differ. Exact: its
  limit is 0.
- ``val_err``: the widest gap of an entry's value from the reference's,
  as a share of Σ|terms| of that entry (the scale of the rounding error a
  sum of those terms can carry). Read only where the structure matches;
  else it is infinite.
"""
from __future__ import annotations

import math

import torch

from .sparse import Mat


def compare(rowptr: torch.Tensor, colidx: torch.Tensor, vals: torch.Tensor,
            ref: Mat) -> dict:
    """{"struct_mismatch": int, "val_err": float} of one output."""
    dev = ref.rowptr.device
    rowptr = rowptr.to(device=dev, dtype=torch.int64)
    if rowptr.shape != ref.rowptr.shape:
        return {"struct_mismatch": abs(rowptr.shape[0] - ref.rowptr.shape[0])
                + 1, "val_err": math.inf}
    lens = rowptr[1:] - rowptr[:-1]
    ref_lens = ref.rowptr[1:] - ref.rowptr[:-1]
    bad_rows = int((lens != ref_lens).sum())
    if bad_rows:
        return {"struct_mismatch": bad_rows, "val_err": math.inf}
    nnz = ref.nnz
    cols = colidx[:nnz].to(device=dev, dtype=torch.int64)
    bad_cols = int((cols != ref.colidx).sum())
    if bad_cols:
        return {"struct_mismatch": bad_cols, "val_err": math.inf}
    if nnz == 0:
        return {"struct_mismatch": 0, "val_err": 0.0}
    got = vals[:nnz].to(device=dev, dtype=torch.float64)
    gap = (got - ref.vals.to(torch.float64)).abs()
    # an entry whose terms are all 0 has to read 0
    scale = torch.where(ref.absv > 0, ref.absv, torch.ones_like(ref.absv))
    rel = torch.where((ref.absv > 0) | (gap == 0), gap / scale,
                      torch.full_like(gap, math.inf))
    err = float(rel.max())
    return {"struct_mismatch": 0, "val_err": err if math.isfinite(err)
            else math.inf}


def worst(readings: list) -> dict:
    """The worst of several outputs' readings, number by number."""
    return {"struct_mismatch": max(r["struct_mismatch"] for r in readings),
            "val_err": max(r["val_err"] for r in readings)}
