"""One-shot products: a caller whose every call brings a structure the
program has never seen, through the facade ``api.spgemm(a, a,
method=<traffic's method>)``.

Call i's operand is P_i·A·P_iᵀ, with P_i a permutation drawn from the seed
and i and applied on the device outside the call's timer, and the
(i mod k)-th value set: the products, nnz(C) and the row lengths stay
those of A, the structure is new. The warm-up is two calls on permutations
that the window never draws: where the host plan's statics come out the
same for every permutation, the program's graph cache (``ops/graphs``)
captures the numeric phase on the second, so the window replays it and
captures nothing.

In the traced run the benchmark's own span ``resolve_method`` times the
facade's dispatch and host plan (``api.resolve_method``) inside each call,
and marks it in the profile, so the device's idle gaps name it.
"""
from __future__ import annotations

import contextlib
import time

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

    def _permuted(self, i: int):
        nnz = self.ref_colidx.shape[0]
        return inputs.permute(self.ref_rowptr, self.ref_colidx,
                              self.vals[i % self.k, :nnz], self.host[3][0],
                              self.seed, i)

    def prepare(self, i: int):
        import torch
        from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR

        rowptr, colidx, vals = self._permuted(i)
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

    @contextlib.contextmanager
    def instrument(self, spans):
        """Time ``api.resolve_method`` on the host clock, into
        ``spans["resolve_method"]``, under a profiler annotation of that
        name."""
        import torch
        from benchmark_spgemm_using_csr_tpu_torch import api

        inner = api.resolve_method

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("api.resolve_method"):
                    return inner(*args, **kwargs)
            finally:
                spans.setdefault("resolve_method", []).append(
                    time.perf_counter() - t0)

        api.resolve_method = timed
        try:
            yield
        finally:
            api.resolve_method = inner

    def release(self) -> None:
        from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

        graphs.clear()

    def outputs(self, out) -> list:
        return [self.csr_parts(out)]

    def reference(self, i: int, precision: str = "float64") -> list:
        rowptr, colidx, vals = self._permuted(i)
        a = sparse.from_arrays(rowptr, colidx, vals, self.host[3],
                               self.device)
        c, self.products = sparse.spgemm(a, a, precision)
        self.nnz_c = c.nnz
        return [c]
