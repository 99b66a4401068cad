"""Dense SpGEMM for small high-fill matrices: scatter, matmul, extract.

When C = A @ B is nearly structurally dense (the mouse_gene / dense_rows
regime: every row hundreds of nnz, C's fill near 1), the sort-based paths
pay per product for structure that is almost all ones. This path puts the
work into one dense matrix product instead:

1. scatter each CSR's values into a dense operand (one collision-free
   scatter per matrix);
2. one dense matmul, in IEEE float32 whatever the caller's TF32 setting
   (``ieee_fp32``; float64 runs in native float64, bfloat16 in float32);
3. extract C's values at the structural positions the host plan computed,
   by hole fraction: ``identity`` at zero holes, ``shift`` (a stable
   left-compaction, ``stream.shift_compact``) when holes < slots / 8,
   else ``scan`` (``stream.runsum_compact_scan`` on plan-constant
   keys with ``max_run=1``).

The plan's rowptr/colidx are the boolean pattern product, so entries that
cancel numerically stay as explicit zeros, as in scipy's golden.

What differs from the reference package's ``ops/dense.py``: the scan-mode
keys are int64 with the sentinel 2**32 - 1 where the reference uses uint32,
and the shift compaction is one scatter where the reference runs
log2(holes) passes (``disp_bits`` is kept in the plan for parity).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSR, acc_dtype, pad_bucket
from .stream import SENTINEL_U32, runsum_compact_scan, shift_compact


@contextlib.contextmanager
def ieee_fp32():
    """Matrix products inside run in IEEE float32 on CUDA, whatever the
    caller's TF32 setting (the analogue of the reference's
    ``precision=HIGHEST``); the setting is restored on exit."""
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = old


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Static structural plan for the dense path.

    rowptr/colidx: C's structural CSR pattern (pattern product, host-built).
    mode 'shift': p1/p2 = per-slot keep flag / left displacement (holes
    before the slot). mode 'scan': p1 = int64 compaction keys (flat slot
    index at structural slots, 2**32 - 1 at holes), p2 empty. mode
    'identity': C structurally full, no extraction.
    """

    rowptr: torch.Tensor
    colidx: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    nnz_c: int
    cap_c: int
    mode: str
    disp_bits: int
    shape: tuple


def make_dense_plan(a: CSR, b: CSR) -> DensePlan:
    """Host symbolic pass: boolean pattern product -> static structure. The
    plan's tensors live on a.device."""
    import scipy.sparse as sp

    sa = a.to_scipy()
    sb = b.to_scipy()
    pat_a = sp.csr_matrix(
        (np.ones(sa.nnz, np.float64), sa.indices, sa.indptr), shape=sa.shape
    )
    pat_b = sp.csr_matrix(
        (np.ones(sb.nnz, np.float64), sb.indices, sb.indptr), shape=sb.shape
    )
    pat_c = (pat_a @ pat_b).tocsr()
    pat_c.sort_indices()
    m, n = pat_c.shape
    nnz_c = int(pat_c.nnz)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(pat_c.indptr))
    flat = rows * n + pat_c.indices.astype(np.int64)
    slots = m * n
    holes = slots - nnz_c
    dev = a.device
    empty = np.zeros(0, np.int32)
    if holes == 0:
        mode, p1, p2, disp_bits = "identity", empty, empty, 0
    elif holes < slots // 8:  # near-full: the shift compaction
        kept = np.zeros(slots, np.bool_)
        kept[flat] = True
        disp = (np.cumsum(~kept) - ~kept).astype(np.int32)
        mode, p1, p2 = "shift", kept, disp
        disp_bits = max(int(holes).bit_length(), 1)
    else:
        ckeys = np.full(slots, SENTINEL_U32, np.int64)
        ckeys[flat] = flat  # slots < 2**32 by dispatch
        mode, p1, p2, disp_bits = "scan", ckeys, empty, 0
    cap_c = pad_bucket(nnz_c)
    colidx = np.zeros(cap_c, np.int32)
    colidx[:nnz_c] = pat_c.indices
    return DensePlan(
        rowptr=torch.from_numpy(pat_c.indptr.astype(np.int32)).to(dev),
        colidx=torch.from_numpy(colidx).to(dev),
        p1=torch.from_numpy(p1).to(dev),
        p2=torch.from_numpy(p2).to(dev),
        nnz_c=nnz_c,
        cap_c=cap_c,
        mode=mode,
        disp_bits=disp_bits,
        shape=(m, n),
    )


def csr_to_dense(a: CSR) -> torch.Tensor:
    """Collision-free scatter densification in ``acc_dtype`` (bfloat16 as
    float32): padding slots write 0 into a guard row ``m``, which is cut
    off."""
    dense = torch.zeros((a.m + 1, a.n), dtype=acc_dtype(a.vals.dtype),
                        device=a.device)
    dense[a.row_ids().long(), a.colidx.long()] = a.vals.to(dense.dtype)
    return dense[: a.m]


def spgemm_dense(a: CSR, b: CSR, plan: DensePlan) -> CSR:
    """C = A @ B through one dense matmul; structure comes from the plan,
    only values are computed on the device."""
    da = csr_to_dense(a)
    db = da if b is a else csr_to_dense(b)
    with ieee_fp32():
        cd = da @ db
    vals = cd.reshape(-1)
    if plan.mode == "shift":
        (vals,) = shift_compact(plan.p1, plan.p2, [vals])
    elif plan.mode == "scan":
        # one pass on plan-constant keys; max_run=1 makes the run-sum a
        # no-op (every run is a singleton)
        _, vals, _ = runsum_compact_scan(
            plan.p1, vals, w=vals.shape[0], out_cap=plan.cap_c, max_run=1,
        )
    out = torch.zeros(plan.cap_c, dtype=a.vals.dtype, device=vals.device)
    keep = min(plan.nnz_c, vals.shape[0])
    out[:keep] = vals[:keep]
    return CSR(plan.rowptr, plan.colidx, out, plan.shape)


def spgemm_dense_auto(a: CSR, b: CSR) -> CSR:
    """Host-facing wrapper (plan built per call)."""
    return spgemm_dense(a, b, make_dense_plan(a, b))

