"""The benchmark's web-graph configuration ``webbase_1m`` and the port's
grouped ESC path that its cell ``webbase_1m.oneshot`` runs.

- At the full size, on the host alone: the configuration's counts against
  the generator and against webbase-1M's published ones, the dispatcher's
  pick (grouped) and the grouped plan, which PERF.md §4 records, of A
  and of a permuted call's operand.
- On the generator's small member: the grouped plan and output against
  the reference package's on the same CSR, and the output against the
  benchmark's float64 reference at two value sets.
- The small cell through the harness with its own traffic (``auto`` picks
  grouped there too), traced and plain, with the grouped counter read.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu.ops import grouped as jg
import benchmark_spgemm_using_csr_tpu as J

from benchmark_spgemm_using_csr_tpu_torch import api
from benchmark_spgemm_using_csr_tpu_torch.ops import grouped
from benchmark_spgemm_using_csr_tpu_torch.utils import profiling
from spgemm_bench import cells, harness
from spgemm_bench.drivers import oneshot
from spgemm_bench.generators import webbase
from spgemm_bench.reference import compare, sparse
from test_torch_pipelines import assert_same_csr, assert_same_plan, bridge

torch.set_num_threads(2)

CELL = "webbase_1m.oneshot"
SEED = 2**31 + 13
# webbase-1M's published counts (SuiteSparse; products by Liu and Vinter)
# and the share of each that the generator must meet
PUBLISHED = {"rows": 1_000_005, "nnz": 3_105_536, "products": 69_500_000}
TOLERANCE = {"rows": 0.0, "nnz": 0.05, "products": 0.05}
# the full-size grouped plan (GroupedPlan fields) that PERF.md §4 records:
# aligned, al = 8; the widest rows set every group's slots
FULL_PLAN = {"k": 8, "al": 8, "cs": 5002, "g_cap": 2304,
             "abpad_cap": 9_437_184, "out_cap": 54_525_952,
             "nnz_c": 50_653_228, "cbits": 20, "lbits": 11, "max_run": 4096,
             "scatter_set": True}
FULL_PROD_CAP = 92_196_864
# a permuted call's plan (the cell's operands) differs in lbits alone
PERMUTED = {"lbits": 10}


def _cell(params: dict | None = None) -> dict:
    """The cell, at ``params`` in place of the configuration's where
    given."""
    cell = cells.load(CELL)
    if params is not None:
        cell["config_data"] = dict(cell["config_data"], params=params)
    return cell


def _driver(params: dict | None = None):
    """The cell's one-shot driver with its matrix made."""
    d = oneshot.Driver(_cell(params), SEED, "cpu")
    d.make_matrix()
    return d


def _plan_fields(x) -> dict:
    plan = grouped.make_grouped_plan(x, x).plan
    assert plan.prod_cap == FULL_PROD_CAP
    return {k: getattr(plan, k) for k in FULL_PLAN}


def test_the_full_size_counts_pick_and_plan_are_the_recorded_ones():
    """Host only, about 10 s: the generator's counts are the
    configuration's and within their tolerances of the published ones;
    ``auto`` picks grouped; the grouped plans are the recorded ones."""
    d = _driver()
    counts = d.config["counts"]
    rowptr, colidx, _, shape = d.host
    made = {"rows": shape[0], "nnz": int(rowptr[-1]),
            "products": int(np.diff(rowptr)[colidx].sum())}
    assert shape == (counts["rows"], counts["rows"])
    assert colidx.size == made["nnz"]
    assert made == {k: counts[k] for k in made}
    for k, want in PUBLISHED.items():
        assert abs(made[k] - want) <= TOLERANCE[k] * want, k
    a = d.operand(0)
    assert api.resolve_method(a, a, {}) == "grouped"
    fields = _plan_fields(a)
    assert fields == FULL_PLAN and fields["nnz_c"] == counts["nnz_c"]
    assert _plan_fields(d.prepare(0)) == dict(FULL_PLAN, **PERMUTED)


def _small_scipy() -> sp.csr_matrix:
    rowptr, colidx, vals, shape = webbase.generate(**webbase.SMALL_PARAMS)
    return sp.csr_matrix((vals, colidx, rowptr), shape=shape)


def test_grouped_on_the_small_member_matches_the_reference_package():
    ja = J.CSR.from_scipy(_small_scipy())
    ta = bridge(ja)
    js, ts = jg.make_grouped_plan(ja, ja), grouped.make_grouped_plan(ta, ta)
    assert_same_plan(js.plan, ts.plan)
    assert_same_csr(jg.spgemm_grouped(ja, ja, js),
                    grouped.spgemm_grouped(ta, ta, ts))


def test_grouped_on_the_small_member_matches_the_reference():
    d = _driver(webbase.SMALL_PARAMS)
    a = d.operand(0)
    assert api.resolve_method(a, a, {}) == "grouped"
    sched = grouped.make_grouped_plan(a, a)
    for i in (0, 1):
        x = d.operand(i)
        out = d.outputs(grouped.spgemm_grouped(x, x, sched))[0]
        ref = d.ref_operand(i)
        r = compare.compare(*out, sparse.spgemm(ref, ref, "float64")[0])
        assert r["struct_mismatch"] == 0 and r["val_err"] < 1e-5


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "plain"])
def test_the_small_cell_runs_through_the_harness(trace):
    """The one-shot driver on the small member; traced, the window's calls
    each count their own plan's slots, and the share reads the products of
    a call over them."""
    profiling.reset()
    r = harness.run(_cell(webbase.SMALL_PARAMS), SEED, 0.3, trace, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    metrics = {k: v["value"] for k, v in r["metrics"].items()}
    if not trace:
        assert {"oneshot_gflops", "setup_s"} <= set(metrics)
        return
    d = _driver(webbase.SMALL_PARAMS)
    rowptr, colidx = d.host[:2]
    products = int(np.diff(rowptr)[colidx].sum())
    calls = r["attempted"]
    slots = sum(grouped.make_grouped_plan(x, x).plan.prod_cap
                for x in (d.prepare(i) for i in range(calls)))
    assert profiling.totals()["counters"]["grouped.slots"] == slots
    assert metrics["oneshot.grouped.slot_share"] == pytest.approx(
        100 * products * calls / slots)
    assert 0 < metrics["oneshot.grouped.slot_share"] < 100
    profiling.reset()
