"""AMG refresh: a caller who builds an aggregation AMG hierarchy once, on
the matrix's own values, and then recomputes every coarse operator R·A·P
for new values on the same fine structure on every call (a time-dependent
PDE on a fixed mesh).

Set-up runs the program's ``models/amg.build_hierarchy`` (the traffic's
``smooth`` and ``max_levels``) and warms ``numeric_refresh`` up three
times (its plans, the capture, a replay). Call i is
``numeric_refresh(h, A_k)`` with the (i mod k)-th value set; its output is
every coarse level's operator.

The reference aggregates the matrix again, smooths its own prolongators
and forms each level's R·(A_k·P) (``reference/amg``); the canonical work
of a call is the chained products A·P and R·(AP) at every level.
"""
from __future__ import annotations

from . import Base, sync
from .. import roofline
from ..reference import amg as ref_amg
from ..reference import sparse

WARMUP_CALLS = 3


class Driver(Base):
    def setup(self) -> None:
        import scipy.sparse as sp
        from benchmark_spgemm_using_csr_tpu_torch.models import amg

        self.make_matrix()
        rowptr, colidx, vals, shape = self.host
        a_sp = sp.csr_matrix((vals, colidx, rowptr), shape=shape)
        self.h = amg.build_hierarchy(
            a_sp, max_levels=int(self.traffic["max_levels"]),
            smooth=bool(self.traffic["smooth"]), device=self.device)
        for i in range(WARMUP_CALLS):
            self.call(self.prepare(i))
        sync(self.device)

    def prepare(self, i: int):
        return self.operand(i % self.k)

    def call(self, x):
        from benchmark_spgemm_using_csr_tpu_torch.models import amg

        return amg.numeric_refresh(self.h, x)

    def release(self) -> None:
        from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

        self.h = None
        graphs.clear()

    def outputs(self, out) -> list:
        return [self.csr_parts(lv.a) for lv in out.levels[1:]]

    def _ref_hierarchy(self) -> ref_amg.Hierarchy:
        if not hasattr(self, "ref_h"):
            rowptr, colidx, vals, shape = self.host
            a0 = sparse.from_arrays(rowptr, colidx, vals, shape, self.device)
            self.ref_h = ref_amg.hierarchy(
                a0, int(self.traffic["max_levels"]),
                bool(self.traffic["smooth"]))
        return self.ref_h

    def reference(self, i: int, precision: str = "float64") -> list:
        h = self._ref_hierarchy()
        coarse, self.counts = ref_amg.coarse_operators(
            h, self.ref_operand(i % self.k), precision)
        self.coarse = coarse
        return coarse

    def work(self) -> roofline.Bound:
        """Every level: R, A and P read once, R·A·P written once, 2·nnzCt
        of A·P and of R·(AP)."""
        if not hasattr(self, "counts"):
            self.reference(0)
        h = self.ref_h
        fine = self.ref_operand(0)
        total = roofline.Bound(0.0, 0.0)
        for a, p, r, out, (n1, n2) in zip([fine] + self.coarse[:-1], h.p,
                                          h.r, self.coarse, self.counts):
            total = total + roofline.product_bound(
                _bytes(r) + _bytes(a), _bytes(p), _bytes(out), n1 + n2)
        return total


def _bytes(a: sparse.Mat) -> int:
    return roofline.csr_bytes(a.shape[0], a.nnz)
