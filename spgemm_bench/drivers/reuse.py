"""Structure reuse: a caller who builds the plan once and then multiplies
matrices of one fixed structure with new values on every call.

Set-up asks the program's dispatcher (``api.resolve_method``) for its
pick on the matrix, builds that method's host plan once, and warms the
planned numeric phase up three times (eager, capture, replay). Call i
computes C = A_k·A_k through the pick's planned numeric phase, with A_k
the (i mod k)-th value set on the fixed structure, so no two consecutive
calls give the same C:

- grouped, tilepack, chunked: the method's ``spgemm_<method>(a, a, plan)``
  (a CUDA graph replay on the card);
- dia: ``ops/dia.dia_spgemm`` on the value set's DIA planes, built at
  set-up by ``DIA.from_csr``, then ``DIA.to_csr(prune=True)``.
"""
from __future__ import annotations

from . import Base, sync
from ..reference import sparse

WARMUP_CALLS = 3


class Driver(Base):
    def setup(self) -> None:
        from benchmark_spgemm_using_csr_tpu_torch import api

        self.make_matrix()
        self.ops = [self.operand(k) for k in range(self.k)]
        plans: dict = {}
        self.method = api.resolve_method(self.ops[0], self.ops[0], plans)
        self.fn = self._planned(self.method, plans)
        for i in range(WARMUP_CALLS):
            self.call(self.prepare(i))
        sync(self.device)

    def _planned(self, method: str, plans: dict):
        """The pick's planned numeric phase, as a function of call i's
        operand."""
        a = self.ops[0]
        if method == "grouped":
            from benchmark_spgemm_using_csr_tpu_torch.ops import grouped

            sched = plans.get("grouped") or grouped.make_grouped_plan(a, a)
            return lambda x: grouped.spgemm_grouped(x, x, sched)
        if method == "tilepack":
            from benchmark_spgemm_using_csr_tpu_torch.ops import tilepack

            sched = plans.get("tilepack") or tilepack.make_tilepack_plan(a, a)
            return lambda x: tilepack.spgemm_tilepack(x, x, sched)
        if method == "chunked":
            from benchmark_spgemm_using_csr_tpu_torch.ops import chunked

            plan = chunked.make_chunked_plan(a, a)
            return lambda x: chunked.spgemm_chunked(x, x, plan)
        if method == "dia":
            from benchmark_spgemm_using_csr_tpu_torch.ops import dia
            from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import DIA

            self.ops = [DIA.from_csr(op, device=self.device)
                        for op in self.ops]
            return lambda x: dia.dia_spgemm(x, x).to_csr(prune=True)
        raise ValueError(f"no structure-reuse path for the pick {method!r}")

    def prepare(self, i: int):
        return self.ops[i % self.k]

    def call(self, x):
        return self.fn(x)

    def release(self) -> None:
        from benchmark_spgemm_using_csr_tpu_torch.ops import graphs

        self.ops = self.fn = None
        graphs.clear()

    def outputs(self, out) -> list:
        return [self.csr_parts(out)]

    def reference(self, i: int, precision: str = "float64") -> list:
        a = self.ref_operand(i % self.k)
        c, self.products = sparse.spgemm(a, a, precision)
        self.nnz_c = c.nnz
        return [c]
