"""bhsparse-compatible object facade.

The reference benchmark exposes one class (``bhsparse``): ``initPlatform /
initData / spgemm / get_nnzC / get_C / free_mem``. This module reproduces
that interface (snake_case) for users porting reference driver code;
inside, everything routes through the functional facade (api.spgemm).

>>> h = BhSparse()
>>> h.init_platform()
>>> h.init_data(m, k, n, rowptr_a, colidx_a, vals_a, rowptr_b, colidx_b, vals_b)
>>> h.spgemm()
>>> nnz_c = h.get_nnz_c()
>>> rowptr_c, colidx_c, vals_c = h.get_c()
>>> h.free_mem()

``amg_hierarchy_from_levels`` carries an AMG hierarchy across from the
reference package: its levels as host arrays in, the port's
``models.amg.AMGHierarchy`` out; ``sharded_csr_from_arrays`` does the same
for a row-sharded matrix (``parallel.dist.ShardedCSR``).
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse.csr import CSR, host_view


class BhSparse:
    """Stateful wrapper mirroring the reference's facade lifecycle."""

    def __init__(self, method: str = "auto"):
        self.method = method
        self._a = None
        self._b = None
        self._c = None
        self._device = None

    def init_platform(self, device: str = "cuda") -> str:
        """Device discovery (the cudaSetDevice analogue): the CUDA device
        unless the caller names another; with no card, "cuda" raises
        rather than falling back to the CPU."""
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("init_platform: no CUDA device is available")
            dev = torch.device("cuda", torch.cuda.current_device()
                               if dev.index is None else dev.index)
        self._device = dev
        return str(dev)

    def init_data(
        self, m, k, n,
        rowptr_a, colidx_a, vals_a,
        rowptr_b, colidx_b, vals_b,
    ) -> None:
        """Host CSR arrays -> containers on the platform's device (the H2D
        copy of initData); init_platform() first if it was not called."""
        import scipy.sparse as sp

        if self._device is None:
            self.init_platform()
        a = sp.csr_matrix(
            (np.asarray(vals_a), np.asarray(colidx_a), np.asarray(rowptr_a)),
            shape=(m, k),
        )
        b = sp.csr_matrix(
            (np.asarray(vals_b), np.asarray(colidx_b), np.asarray(rowptr_b)),
            shape=(k, n),
        )
        self._a = CSR.from_scipy(a, device=self._device)
        self._b = CSR.from_scipy(b, device=self._device)
        self._c = None

    def spgemm(self) -> None:
        from .api import spgemm

        if self._a is None or self._b is None:
            raise RuntimeError("init_data() not called")
        self._c = spgemm(self._a, self._b, method=self.method)

    def get_nnz_c(self) -> int:
        if self._c is None:
            raise RuntimeError("spgemm() not called")
        return int(self._c.rowptr[-1])

    def get_c(self):
        """(rowptr, colidx, vals) host arrays, exact size (the D2H copy)."""
        nnz = self.get_nnz_c()
        return (
            host_view(self._c.rowptr).copy(),
            host_view(self._c.colidx)[:nnz].copy(),
            host_view(self._c.vals)[:nnz].copy(),
        )

    def free_mem(self) -> None:
        self._a = self._b = self._c = None


def amg_hierarchy_from_levels(levels, *, device):
    """The port's AMGHierarchy from the reference package's levels.

    levels: one (a, p) pair per level, each a ``(rowptr, colidx, vals,
    shape)`` tuple of host arrays (``np.asarray`` of the reference CSR's
    buffers, as its ``AMGHierarchy.save`` writes them), p None on the
    finest level. R is P's transpose, as ``AMGHierarchy.load`` makes it."""
    from .models.amg import AMGHierarchy, Level
    from .sparse.csr import csr_transpose

    out = []
    for a, p in levels:
        a = CSR.from_numpy(*a, device=device)
        p = None if p is None else CSR.from_numpy(*p, device=device)
        out.append(Level(a=a, p=p, r=None if p is None else csr_transpose(p)))
    return AMGHierarchy(out)


def sharded_csr_from_arrays(rowptr, colidx, vals, shape, bounds=None, *,
                            device):
    """The port's ``parallel.dist.ShardedCSR`` from the reference package's:
    its stacked (P, m_loc + 1) rowptr and (P, cap) colidx / vals as host
    arrays (``np.asarray`` of its buffers), its shape and its bounds (None
    for the uniform partition), on ``device``. ``dist.local_shard(sh,
    rank)`` then gives a rank's block."""
    from .parallel.dist import ShardedCSR

    rowptr = np.asarray(rowptr, np.int32)
    colidx = np.asarray(colidx, np.int32)
    vals = np.asarray(vals)
    if rowptr.ndim != 2 or colidx.shape != vals.shape or (
            colidx.shape[:1] != rowptr.shape[:1]):
        raise ValueError(f"stacked shapes disagree: rowptr {rowptr.shape}, "
                         f"colidx {colidx.shape}, vals {vals.shape}")
    return ShardedCSR(
        torch.from_numpy(rowptr.copy()).to(device),
        torch.from_numpy(colidx.copy()).to(device),
        torch.from_numpy(vals.copy()).to(device),
        (int(shape[0]), int(shape[1])),
        bounds=None if bounds is None else tuple(int(x) for x in bounds),
    )
