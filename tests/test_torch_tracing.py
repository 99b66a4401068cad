"""The port's spans and counters (``utils/profiling``) and the benchmark's
readers of them (``spgemm_bench/metrics``).

On the CPU: the recorder is off unless a profiler records or
``recording()`` is entered; each span fires where and as often as the
benchmark cells' paths reach it; the spans are the profiler's host
annotations; tracing changes no output. The tests marked ``cuda`` hold
the counters against the card (the bytes a graph replay copies, the
syncs ``torch.cuda.set_sync_debug_mode`` reports, the chunked and grouped
plans' slots a capture and a replay count); run them there
without the repository's conftest:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""
import json
import os
import types
import warnings

import pytest
import torch

from benchmark_spgemm_using_csr_tpu_torch import api
from benchmark_spgemm_using_csr_tpu_torch.models import amg
from benchmark_spgemm_using_csr_tpu_torch.ops import graphs
from benchmark_spgemm_using_csr_tpu_torch.ops.dia import dia_spgemm
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR, host_view
from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import DIA
from benchmark_spgemm_using_csr_tpu_torch.utils import generators, profiling
from spgemm_bench.cells import reader

torch.set_num_threads(2)

ESTIMATES = ("chunked", "bsr", "dia", "dense", "tilepack", "grouped", "hash")
# the blocking points of one DIA.to_csr off the card (its plain version):
# the offsets' copy to the device and three boolean masks; on the card
# kernel K4 has none
TO_CSR_SYNCS = 4


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def _circuit(device="cpu", n=2048):
    return CSR.from_scipy(generators.circuit(n), device=device)


def _auto(device="cpu", n=2048):
    a = _circuit(device, n)
    return lambda: api.spgemm(a, a, method="auto")


def _dia(device="cpu", grid=24):
    d = DIA.from_csr(CSR.from_scipy(generators.poisson2d(grid), device=device),
                     device=device)
    return lambda: dia_spgemm(d, d).to_csr(prune=True)


def _refresh(device="cpu", grid=24, warm=1):
    """One refresh of a 2-level smoothed hierarchy (the refresh cell's
    route: the triple plan), after ``warm`` refreshes that build its
    plans (and on the card capture its graph)."""
    s = generators.poisson2d(grid)
    h = amg.build_hierarchy(s, max_levels=2, smooth=True, device=device)
    a = CSR.from_scipy(s * 1.5, device=device)
    for _ in range(warm):
        amg.numeric_refresh(h, a)
    assert h._triple_plans[1][0] == "triple"
    return lambda: amg.numeric_refresh(h, a)


def _fem_plan(device="cpu"):
    """A small irregular FEM matrix and its chunked plan."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import chunked

    a = CSR.from_scipy(generators.fem_irregular(6, dof=3, fill=0.95,
                                                seed=15), device=device)
    return a, chunked.make_chunked_plan(a, a)


def _chunked(device="cpu"):
    """A planned chunked call (fem_81k.reuse's route) on ``_fem_plan``."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import chunked

    a, plan = _fem_plan(device)
    return lambda: chunked.spgemm_chunked(a, a, plan)


def _parts(out):
    if isinstance(out, amg.AMGHierarchy):
        return [t for lv in out.levels[1:]
                for t in (lv.a.rowptr, lv.a.colidx, lv.a.vals)]
    return [out.rowptr, out.colidx, out.vals]


# ``_fem_plan``'s slots and out_cap, and its rows: every row fits kernel K6,
# so the plan takes the row-local route (its products staged, C at its
# exact size)
CHUNKED_SLOTS, CHUNKED_OUT_SLOTS, CHUNKED_ROWS = 2077461, 131072, 648
# the grouped plan's prod_cap on ``_circuit()``: the slots its call expands,
# sorts and run-sums
GROUPED_SLOTS = 294480
# span -> calls for one call of each path on the CPU; counters besides
EXPECTED = {
    # the grouped plan counts nnz(C) (on the CPU with scipy)
    "auto": ({"api.spgemm": 1, "dispatch.choose": 1, "dispatch.stats": 1,
              **{f"dispatch.estimate.{m}": 1 for m in ESTIMATES},
              "api.plan": 1, "plan.nnz_c": 1, "grouped.spgemm": 1,
              "graphs.eager": 1},
             # the trim reads nnz(C) twice; the grouped schedule's four
             # copies to the device; the plan's product slots
             {"host.syncs": 6, "grouped.slots": GROUPED_SLOTS}),
    "dia": ({"dia.spgemm": 1, "dia.to_csr": 1},
            {"host.syncs": TO_CSR_SYNCS}),
    "refresh": ({"amg.refresh": 1, "graphs.eager": 1}, {}),
    # the plan's slots, out_cap and the rows K6 takes
    "chunked": ({"chunked.spgemm": 1, "graphs.eager": 1},
                {"chunked.slots": CHUNKED_SLOTS,
                 "chunked.out_slots": CHUNKED_OUT_SLOTS,
                 "chunked.rowlocal_rows": CHUNKED_ROWS}),
}
PATHS = {"auto": _auto, "dia": _dia, "refresh": _refresh, "chunked": _chunked}


def test_off_by_default_records_nothing():
    _auto()()
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_off_a_span_is_one_shared_no_op():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 5)
    assert profiling.totals() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_span_fires_as_often_as_the_path_reaches_it(path):
    call = PATHS[path]()
    with profiling.recording():
        call()
    got = profiling.totals()
    spans, counters = EXPECTED[path]
    assert {k: n for k, (n, _) in got["spans"].items()} == spans
    assert got["counters"] == counters
    assert all(s >= 0 for _, s in got["spans"].values())


def test_plan_and_choose_are_disjoint_parts_of_the_call():
    a = _circuit()
    with profiling.recording():
        api.spgemm(a, a, method="auto")
    spans = profiling.totals()["spans"]
    choose, plan, call = (spans[k][1] for k in
                          ("dispatch.choose", "api.plan", "api.spgemm"))
    inner = sum(spans[f"dispatch.estimate.{m}"][1] for m in ESTIMATES)
    assert inner + spans["dispatch.stats"][1] <= choose
    assert choose + plan <= call


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_are_bit_equal_with_tracing_on_and_off(path):
    call = PATHS[path]()
    off = _parts(call())
    with profiling.recording():
        on = _parts(call())
    assert len(on) == len(off)
    for x, y in zip(on, off):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _annotations(tmp_path, call):
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tmp_path, "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            out.setdefault(e["name"], []).append((t0, t0 + float(e["dur"])))
    return out


def test_the_spans_are_the_profilers_host_annotations(tmp_path):
    ann = _annotations(tmp_path, _auto())
    assert set(EXPECTED["auto"][0]) <= set(ann)
    (c0, c1), = ann["dispatch.choose"]
    (t0, t1), = ann["dispatch.estimate.tilepack"]
    (p0, p1), = ann["api.plan"]
    (s0, s1), = ann["api.spgemm"]
    assert c0 <= t0 <= t1 <= c1
    assert c1 <= p0 or p1 <= c0
    assert s0 <= min(c0, p0) and max(c1, p1) <= s1
    # the profile's records went to the registry too
    assert profiling.totals()["spans"]["dispatch.choose"][0] == 1


def test_only_the_profilers_active_step_records():
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        profiling.count("warm-up")
        prof.step()
        profiling.count("active")
        seen.append(profiling.totals()["counters"])
        prof.step()
    profiling.count("after")
    assert seen == [{"active": 1}]
    assert profiling.totals()["counters"] == {"active": 1}


def test_reset_clears_the_registry_and_graphs_clear_leaves_it():
    with profiling.recording():
        with profiling.span("s"):
            profiling.count("c", 3)
    graphs.clear()
    got = profiling.totals()
    assert got["counters"] == {"c": 3}
    assert list(got["spans"]) == ["s"] and got["spans"]["s"][0] == 1
    profiling.reset()
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_recording_nests_and_ends():
    with profiling.recording():
        with profiling.recording():
            profiling.count("c")
        profiling.count("c")
    profiling.count("c")
    assert profiling.totals()["counters"] == {"c": 2}


# each new reader: (what the registry holds, the value for 4 calls)
READERS = {
    "oneshot.dispatch.host_ms": ({"spans": {"dispatch.choose": (4, 2.0)}},
                                 500.0),
    "oneshot.plan.host_ms": ({"spans": {"api.plan": (4, 0.2)}}, 50.0),
    "oneshot.host.copy_mb": ({"counters": {"host.d2h_bytes": 36 << 20}},
                             9.0),
    "paced.host.syncs": ({"counters": {"host.syncs": 12}}, 3.0),
    "graphs.copy_mb": ({"counters": {"graphs.copy_bytes": 2200 << 20}},
                       550.0),
    "paced.graphs.copy_mb": ({"counters": {"graphs.copy_bytes": 1688 << 20}},
                             422.0),
}


def _registry(monkeypatch, spans=None, counters=None):
    held = {"spans": dict(spans or {}), "counters": dict(counters or {})}
    monkeypatch.setattr(profiling, "totals", lambda: held)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_span_or_counter_per_call(monkeypatch, name):
    held, want = READERS[name]
    _registry(monkeypatch, **held)
    assert reader(name)(types.SimpleNamespace(calls=4)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_where_nothing_was_recorded(monkeypatch,
                                                            name):
    ctx = types.SimpleNamespace(calls=4)
    _registry(monkeypatch)
    assert reader(name)(ctx) is None
    # a program without the recorder (the port before it had one)
    monkeypatch.delattr(profiling, "totals")
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reads_none_and_a_counter_zero_when_others_fired(monkeypatch,
                                                                name):
    """A traced window whose calls never reached this span or counter: a
    counter reads 0 (the refresh blocks the host nowhere), a span None."""
    _registry(monkeypatch, spans={"other": (1, 1.0)},
              counters={"other": 1})
    got = reader(name)(types.SimpleNamespace(calls=4))
    assert got == (None if name.endswith("host_ms") else 0.0)


def test_the_chunked_counters_grow_by_the_plan_every_call():
    _, plan = _fem_plan()
    assert (plan.slots, plan.out_cap) == (CHUNKED_SLOTS, CHUNKED_OUT_SLOTS)
    call = _chunked()
    call()
    assert profiling.totals() == {"spans": {}, "counters": {}}
    for k in (1, 2, 3):
        with profiling.recording():
            call()
        got = profiling.totals()
        assert got["spans"]["chunked.spgemm"][0] == k
        assert got["counters"] == {"chunked.slots": k * CHUNKED_SLOTS,
                                   "chunked.out_slots": k * CHUNKED_OUT_SLOTS,
                                   "chunked.rowlocal_rows": k * CHUNKED_ROWS}


def _grouped(device="cpu", n=2048):
    """A planned grouped call (the one-shot cells' numeric phase) on
    ``_circuit``."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import grouped

    a = _circuit(device, n)
    sched = grouped.make_grouped_plan(a, a)
    return sched, lambda: grouped.spgemm_grouped(a, a, sched)


def test_the_grouped_counter_grows_by_the_plans_slots_every_call():
    """Eager on the CPU: each call adds its plan's ``prod_cap`` once and
    fires the span once; with no profiler recording, neither."""
    sched, call = _grouped()
    assert sched.plan.prod_cap == GROUPED_SLOTS
    call()
    assert profiling.totals() == {"spans": {}, "counters": {}}
    for k in (1, 2, 3):
        with profiling.recording():
            call()
        got = profiling.totals()
        assert {n: c for n, (c, _) in got["spans"].items()} == {
            "grouped.spgemm": k, "graphs.eager": k}
        assert got["counters"] == {"grouped.slots": k * GROUPED_SLOTS}


# the readers of a plan's counters, chunked and grouped: (counter, its
# reading for 4 calls, the value); a slot share's work is 3e6 products a
# call
CHUNKED_READERS = {
    "chunked.slot_share": ("chunked.slots", 4 * 4_000_000, 75.0),
    "oneshot.grouped.slot_share": ("grouped.slots", 4 * 5_000_000, 60.0),
    "chunked.out_slots_m": ("chunked.out_slots", 4 * 2_500_000, 2.5),
    "chunked.rowlocal_rows_k": ("chunked.rowlocal_rows", 4 * 81_000, 81.0),
}


def _ctx(calls=4):
    from spgemm_bench.roofline import Bound

    return types.SimpleNamespace(calls=calls,
                                 work=Bound(bytes_moved=1.0, flops=6e6))


@pytest.mark.parametrize("name", sorted(CHUNKED_READERS))
def test_a_chunked_reader_reads_its_counter_per_call(monkeypatch, name):
    counter, n, want = CHUNKED_READERS[name]
    _registry(monkeypatch, counters={counter: n})
    assert reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CHUNKED_READERS))
def test_a_chunked_reader_reads_nothing_without_its_counter(monkeypatch,
                                                            name):
    """None with nothing recorded, with no recorder at all (the port
    before it had one), where other spans fired but its counter reads 0,
    and where the window had no calls."""
    counter, n, _ = CHUNKED_READERS[name]
    _registry(monkeypatch)
    assert reader(name)(_ctx()) is None
    _registry(monkeypatch, spans={"graphs.replay": (4, 1.0)},
              counters={"graphs.copy_bytes": 1})
    assert reader(name)(_ctx()) is None
    _registry(monkeypatch, counters={counter: 0})
    assert reader(name)(_ctx()) is None
    _registry(monkeypatch, counters={counter: n})
    assert reader(name)(_ctx(calls=0)) is None
    monkeypatch.delattr(profiling, "totals")
    assert reader(name)(_ctx()) is None


# -- on the card -----------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_replay_adds_the_bytes_it_copies_in_and_clones_out():
    need_card()
    from benchmark_spgemm_using_csr_tpu_torch.ops import grouped

    graphs.clear()
    a = _circuit("cuda", 1 << 14)
    sched = grouped.make_grouped_plan(a, a)
    for _ in range(2):  # eager, then the capture (and its replay)
        grouped.spgemm_grouped(a, a, sched)
    (g,) = graphs._graphs.values()
    for k in (1, 2, 3):
        with profiling.recording():
            grouped.spgemm_grouped(a, a, sched)
        torch.cuda.synchronize()
        assert profiling.totals()["counters"]["graphs.copy_bytes"] == (
            k * (g.in_bytes + g.out_bytes))
    graphs.clear()


@pytest.mark.cuda
def test_a_host_view_miss_counts_its_copy_and_sync():
    need_card()
    x = torch.arange(1000, dtype=torch.int32, device="cuda")
    with profiling.recording():
        host_view(x)
        host_view(x)  # the memo's hit: no copy
    got = profiling.totals()
    assert got["counters"] == {"host.syncs": 1, "host.d2h_bytes": 4000}
    assert got["spans"]["host.copy"][0] == 1


def _plan(method, device="cpu"):
    """One host plan, counting nnz(C): grouped on the circuit, tilepack on
    the stencil."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import grouped, tilepack

    if method == "grouped":
        a = _circuit(device, 1 << 14)
        return lambda: grouped.make_grouped_plan(a, a)
    a = CSR.from_scipy(generators.poisson2d(128), device=device)
    return lambda: tilepack.make_tilepack_plan(a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dia", "refresh", "auto", "grouped",
                                  "tilepack"])
def test_host_syncs_are_the_syncs_the_card_reports(path):
    """One call of each path: ``host.syncs`` equals the synchronising
    operations ``torch.cuda.set_sync_debug_mode("warn")`` reports; the dia
    path (K3, then K4's conversion) reports none; a plan, its copies to
    the device and K5's count read back."""
    need_card()
    graphs.clear()
    call = {"dia": lambda: _dia("cuda", 256),
            "refresh": lambda: _refresh("cuda", 128, warm=3),
            "auto": lambda: _auto("cuda", 1 << 16),
            "grouped": lambda: _plan("grouped", "cuda"),
            "tilepack": lambda: _plan("tilepack", "cuda")}[path]()
    for _ in range(2):  # builds, plans, and a graph's capture
        call()
    torch.cuda.synchronize()
    profiling.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording():
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    reported = sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in caught)
    assert profiling.totals()["counters"].get("host.syncs", 0) == reported
    if path == "dia":
        assert reported == 0
    graphs.clear()


@pytest.mark.cuda
def test_a_chunked_replay_counts_its_plans_slots():
    need_card()
    graphs.clear()
    call = _chunked("cuda")
    for _ in range(2):  # eager, then the capture (and its replay)
        call()
    torch.cuda.synchronize()
    assert graphs.info()["captures"] == 1
    for k in (1, 2):
        with profiling.recording():
            call()
        torch.cuda.synchronize()
        got = profiling.totals()
        assert {n: c for n, (c, _) in got["spans"].items()} == {
            "chunked.spgemm": k, "graphs.replay": k}
        assert got["counters"]["chunked.slots"] == k * CHUNKED_SLOTS
        assert got["counters"]["chunked.out_slots"] == k * CHUNKED_OUT_SLOTS
        assert got["counters"]["chunked.rowlocal_rows"] == k * CHUNKED_ROWS
    graphs.clear()


@pytest.mark.cuda
def test_a_grouped_capture_and_replay_count_their_plans_slots():
    """On the card the second call captures and the later ones replay:
    each adds the plan's slots once, and none blocks the host (the plan's
    copies were made before)."""
    need_card()
    graphs.clear()
    sched, call = _grouped("cuda", 1 << 14)
    slots = sched.plan.prod_cap
    with profiling.recording():
        call()  # eager
    torch.cuda.synchronize()
    assert profiling.totals()["counters"] == {"grouped.slots": slots}
    for k, branch in ((2, "graphs.capture"), (3, "graphs.replay")):
        with profiling.recording():
            call()
        torch.cuda.synchronize()
        got = profiling.totals()
        assert got["spans"]["grouped.spgemm"][0] == k
        assert got["spans"][branch][0] >= 1
        assert got["counters"]["grouped.slots"] == k * slots
        assert "host.syncs" not in got["counters"]
    assert graphs.info()["captures"] == 1
    graphs.clear()


def _choose(device="cpu"):
    """The dispatcher's pick on the circuit's structure, in new index
    buffers every call (the one-shot cells' operands)."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch

    a = _circuit(device, 1 << 14)

    def call():
        x = CSR(a.rowptr.clone(), a.colidx.clone(), a.vals, a.shape)
        return dispatch.choose_method(x, x)
    return call


def test_the_dispatcher_prices_on_the_host_off_the_card():
    """CPU operands take K7's plain version: the counter
    ``dispatch.stats.device`` stays 0 and nothing blocks."""
    call = _choose()
    with profiling.recording():
        call()
        call()
    got = profiling.totals()
    assert got["spans"]["dispatch.stats"][0] == 2
    assert got["counters"] == {}


@pytest.mark.cuda
def test_the_dispatcher_prices_each_pair_once_with_k7():
    """On the card each new pair is priced from one K7 call and its one read
    back (``dispatch.stats.device`` +1 and one ``host.syncs``, the syncs the
    card reports); the same tensors again launch nothing and block
    nowhere."""
    need_card()
    from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch, pair_stats

    call = _choose("cuda")
    call()  # the build
    torch.cuda.synchronize()
    for k in (1, 2, 3):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.recording():
                    assert call() == "grouped"
            finally:
                torch.cuda.set_sync_debug_mode(0)
        reported = sum("called a synchronizing CUDA operation"
                       in str(w.message) for w in caught)
        got = profiling.totals()["counters"]
        assert got == {"dispatch.stats.device": k, "host.syncs": k}
        assert reported == 1
    a = _circuit("cuda", 1 << 14)
    dispatch.choose_method(a, a)
    launches = pair_stats.pair_stats.launches
    profiling.reset()
    with profiling.recording():
        dispatch.choose_method(a, a)
    assert pair_stats.pair_stats.launches == launches
    assert profiling.totals()["counters"] == {}


# a plan's blocking points on the card once its operands' host views are
# held: its copies to the device, and K5's count read back
PLAN_SYNCS = {"grouped": 4 + 1, "tilepack": 3 + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(PLAN_SYNCS))
def test_a_plan_on_the_card_counts_nnz_c_with_k5(method):
    """Each plan built on the card counts nnz(C) once with K5: the span
    ``plan.nnz_c``, the counter ``plan.nnz_c.device`` and one more
    ``host.syncs`` (the 8-byte read) than its copies."""
    need_card()
    call = _plan(method, "cuda")
    call()  # the operands' host views
    for k in (1, 2):
        with profiling.recording():
            call()
        got = profiling.totals()
        assert got["spans"]["plan.nnz_c"][0] == k
        assert got["counters"] == {"plan.nnz_c.device": k,
                                   "host.syncs": k * PLAN_SYNCS[method]}


@pytest.mark.parametrize("method", sorted(PLAN_SYNCS))
def test_a_plan_on_the_cpu_counts_nnz_c_with_scipy(method):
    """Off the card the count is scipy's: the span fires, K5's counter
    does not."""
    call = _plan(method)
    with profiling.recording():
        call()
    got = profiling.totals()
    assert got["spans"]["plan.nnz_c"][0] == 1
    assert "plan.nnz_c.device" not in got["counters"]
    assert got["counters"]["host.syncs"] == PLAN_SYNCS[method] - 1
