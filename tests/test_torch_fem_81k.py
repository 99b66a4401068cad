"""The benchmark's FEM configuration ``fem_81k`` and the port's chunked ESC
path that its cell ``fem_81k.reuse`` runs.

- The benchmark's frozen generator (``spgemm_bench/generators/
  fem_irregular.py``) makes the port's ``fem_irregular`` array for array.
- At the full size, on the host alone: the configuration's counts, the
  dispatcher's pick (chunked) and the plan's mode and capacities, which
  PERF.md §4 records: the row-local route (kernel K6) and C sized at
  ``pad_gentle(nnz(C))``.
- On the generator's small member, the chunked numeric phase in the
  full-size plan's mode (aligned, al = 16, scatter-SET): its plan and
  output against the reference package's on the same CSR, and its output
  against the benchmark's float64 reference at two value sets.
- The small cell through the harness with the pick forced to chunked (the
  full size's route; ``auto`` picks grouped at the small size), traced and
  plain: the reuse driver's chunked branch and the chunked counters.
"""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark_spgemm_using_csr_tpu.ops import chunked as jc
import benchmark_spgemm_using_csr_tpu as J

from benchmark_spgemm_using_csr_tpu_torch import api
from benchmark_spgemm_using_csr_tpu_torch.ops import chunked
from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import dia_offsets_of
from benchmark_spgemm_using_csr_tpu_torch.utils import generators
from spgemm_bench import cells, harness
from spgemm_bench.drivers import reuse
from spgemm_bench.generators import fem_irregular
from spgemm_bench.reference import compare
from test_torch_pipelines import assert_same_csr, assert_same_plan, bridge

torch.set_num_threads(2)

CELL = "fem_81k.reuse"
# the full-size plan (ChunkedPlan fields) that PERF.md §4 records: the
# stream's fields, and on the row-local route C at pad_gentle(26,665,092)
FULL_PLAN = {"k": 16, "al": 16, "al_min": 0, "wide_min": 0,
             "scatter_set": True, "max_run": 128, "chunks_cap": 31_457_280,
             "abpad_cap": 6_815_744, "out_cap": 27_262_976}
FULL_PROD_CAP = 503_316_480
# K6's launch at the full size: the widest row's 6,426 products and 375
# columns, 512 threads; every product staged once
FULL_ROUTE = {"smem": 99_096, "threads": 512, "slots": 429_654_051}
FULL_DIAGONALS = 11_004  # more than dia's gate of 4,096


def _cell(params: dict | None = None) -> dict:
    """The cell, at ``params`` in place of the configuration's where
    given."""
    cell = cells.load(CELL)
    if params is not None:
        cell["config_data"] = dict(cell["config_data"], params=params)
    return cell


def _driver(params: dict | None = None, seed: int = 2**31 + 7):
    """The cell's structure-reuse driver with its matrix made."""
    d = reuse.Driver(_cell(params), seed, "cpu")
    d.make_matrix()
    return d


@pytest.mark.parametrize("params", [
    fem_irregular.SMALL_PARAMS,
    {"k": 9, "dof": 1, "fill": 0.95, "seed": 15},  # the dof == 1 branch
    {"k": 8, "dof": 3, "fill": 0.7, "seed": 3},  # a random permutation
], ids=["small", "dof1", "random"])
def test_the_frozen_generator_makes_the_ports_matrix(params):
    rowptr, colidx, vals, shape = fem_irregular.generate(**params)
    ref = generators.fem_irregular(**params)
    assert shape == ref.shape
    for got, want in ((rowptr, ref.indptr), (colidx, ref.indices),
                      (vals, ref.data)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_full_size_pick_and_plan_are_the_recorded_ones():
    """Host only, about 3 s: rows and nnz of the configuration, its
    products, ``auto``'s pick and the chunked plan at the full size."""
    d = _driver()
    counts = d.config["counts"]
    rowptr, colidx, _, shape = d.host
    assert shape == (counts["rows"], counts["rows"])
    assert int(rowptr[-1]) == colidx.size == counts["nnz"]
    assert int(np.diff(rowptr)[colidx].sum()) == counts["products"]
    a = d.operand(0)
    assert len(dia_offsets_of(a)) == FULL_DIAGONALS
    assert api.resolve_method(a, a, {}) == "chunked"
    plan = chunked.make_chunked_plan(a, a)
    assert {k: getattr(plan, k) for k in FULL_PLAN} == FULL_PLAN
    assert plan.prod_cap == FULL_PROD_CAP
    assert dataclasses.asdict(plan.rowlocal) == FULL_ROUTE
    assert plan.slots == counts["products"]


def test_chunked_in_the_full_size_mode_matches_the_reference():
    d = _driver(fem_irregular.SMALL_PARAMS)
    a = d.operand(0)
    plan = chunked.make_chunked_plan(a, a, al=16)
    assert (plan.k, plan.al, plan.al_min, plan.wide_min) == (16, 16, 0, 0)
    assert plan.scatter_set
    for i in (0, 1):
        x = d.operand(i)
        out = d.outputs(chunked.spgemm_chunked(x, x, plan))[0]
        r = compare.compare(*out, d.reference(i)[0])
        assert r["struct_mismatch"] == 0 and r["val_err"] < 1e-5


def test_chunked_in_the_full_size_mode_matches_the_reference_package():
    """The FEM regime's plan (aligned, al = 16, scatter-SET, runs of up to
    ``max_run`` duplicates) and its output: the port's against the JAX
    package's on the same small member."""
    ja = J.CSR.from_scipy(generators.fem_irregular(**fem_irregular.SMALL_PARAMS))
    ta = bridge(ja)
    jp = jc.make_chunked_plan(ja, ja, al=16)
    tp = chunked.make_chunked_plan(ta, ta, al=16)
    assert tp.al == 16 and tp.scatter_set
    assert_same_plan(jp, tp)
    assert_same_csr(jc.spgemm_chunked(ja, ja, jp),
                    chunked.spgemm_chunked(ta, ta, tp))


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "plain"])
def test_the_cell_passes_through_the_drivers_chunked_branch(monkeypatch,
                                                            trace):
    monkeypatch.setattr(api, "resolve_method", lambda a, b, plans: "chunked")
    r = harness.run(_cell(fem_irregular.SMALL_PARAMS), 2**31 + 11, 0.2,
                    trace, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    if not trace:
        assert "gflops" in r["metrics"]
        return
    d = _driver(fem_irregular.SMALL_PARAMS)
    a = d.operand(0)
    plan = chunked.make_chunked_plan(a, a)
    rowptr, colidx = d.host[:2]
    products = int(np.diff(rowptr)[colidx].sum())
    metrics = {k: v["value"] for k, v in r["metrics"].items()}
    assert plan.rowlocal is not None  # every row fits K6
    assert metrics["chunked.slot_share"] == pytest.approx(
        100 * products / plan.slots) == pytest.approx(100.0)
    assert metrics["chunked.out_slots_m"] == pytest.approx(
        plan.out_cap / 1e6)
    assert metrics["chunked.rowlocal_rows_k"] == pytest.approx(a.m / 1e3)
