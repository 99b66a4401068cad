"""One-shot products: a caller whose every call brings operands the
program has never seen, through the facade ``api.spgemm(a, a,
method=<traffic's method>)``.

Call i's operand carries the (i mod k)-th value set and is made outside
the call's timer, in new device tensors every call, so no cache keyed by
a tensor's identity hits. Its structure is, by the traffic's ``permute``
(true unless it says otherwise):

- true: P_i·A·P_iᵀ, with P_i a permutation drawn from the seed and i and
  applied on the device. The products, nnz(C) and the row lengths stay
  those of A, the structure is new;
- false: A's own structure, so a stencil keeps its diagonals and the
  dispatcher's pick is A's own.

The warm-up is two calls at indices the window never reaches: where the
host plan's statics come out the same every call, the program's graph
cache (``ops/graphs``) captures the numeric phase on the second, so the
window replays it and captures nothing.
"""
from __future__ import annotations

from . import Base, sync
from .. import inputs
from ..reference import sparse

WARMUP_INDICES = (-1, -2)


class Driver(Base):
    def setup(self) -> None:
        self.make_matrix()
        self.method = self.traffic.get("method", "auto")
        for i in WARMUP_INDICES:
            self.call(self.prepare(i))
        sync(self.device)

    def _arrays(self, i: int):
        """(rowptr, colidx, vals) of call i's operand (module docstring)."""
        nnz = self.ref_colidx.shape[0]
        vals = self.vals[i % self.k, :nnz]
        if not self.traffic.get("permute", True):
            return self.ref_rowptr, self.ref_colidx, vals
        return inputs.permute(self.ref_rowptr, self.ref_colidx, vals,
                              self.host[3][0], self.seed, i)

    def prepare(self, i: int):
        import torch
        from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR

        rowptr, colidx, vals = self._arrays(i)
        nnz = colidx.shape[0]
        col = torch.zeros(self.capacity, dtype=torch.int32,
                          device=self.device)
        val = torch.zeros(self.capacity, dtype=torch.float32,
                          device=self.device)
        col[:nnz] = colidx
        val[:nnz] = vals
        return CSR(rowptr.to(torch.int32), col, val, self.host[3])

    def call(self, x):
        from benchmark_spgemm_using_csr_tpu_torch import api

        return api.spgemm(x, x, method=self.method)

    def release(self) -> None:
        from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

        graphs.clear()

    def outputs(self, out) -> list:
        return [self.csr_parts(out)]

    def reference(self, i: int, precision: str = "float64") -> list:
        rowptr, colidx, vals = self._arrays(i)
        a = sparse.from_arrays(rowptr, colidx, vals, self.host[3],
                               self.device)
        c, self.products = sparse.spgemm(a, a, precision)
        self.nnz_c = c.nnz
        return [c]
