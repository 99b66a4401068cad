"""The port's suite harness (benchmark_spgemm_using_csr_tpu_torch/bench.py)
on the CPU against the reference package: the pair's pick, the point
function's flop count, nnz(C) and pick on small suite members, the
headline's keys, failures, the device default, the signals and where it
writes. The harness holds every C against scipy through utils/oracle, at
the CLI's float32 tolerances (rtol 1e-4 / atol 1e-5; float64 1e-12)."""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.ops import dispatch as jdispatch
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch import bench
from benchmark_spgemm_using_csr_tpu_torch.ops import chunked as tchunked
from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch as tdispatch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"n_scored", "spread_max", "gmean_r1suite", "gmean_r2suite",
               "device", "failed"}


def headline(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_points_are_the_reference_benchs():
    assert len(bench.SUITE_NAMES) == 22 and len(bench.PAIR_NAMES) == 1
    assert set(bench.SUITE_NAMES) <= set(jgen.SUITE)
    assert bench.PAIR_NAMES == tuple(jgen.SUITE_PAIRS)
    assert len(set(bench.POINTS)) == len(bench.POINTS) == 31


def test_pair_pick_equals_reference_bench():
    a_sp, b_sp = jgen.SUITE_PAIRS["rect_96k_24k_48k"]()
    ja, jb = J.CSR.from_scipy(a_sp), J.CSR.from_scipy(b_sp)
    est = {  # bench.py:550-555
        "chunked": jdispatch.estimate_chunked_s(ja, jb),
        "grouped": jdispatch.estimate_grouped_s(ja, jb),
        "tilepack": jdispatch.estimate_tilepack_s(ja, jb),
    }
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    tb = T.CSR.from_scipy(b_sp, device="cpu")
    assert bench.pair_method(ta, tb) == min(est, key=est.get) == "grouped"


@pytest.mark.parametrize("name", ["er_small", "powerlaw_small",
                                  "poisson2d_64", "banded_16k"])
def test_point_reports_reference_flops_and_nnz(name):
    a_sp = jgen.SUITE[name]()
    row = bench.spgemm_point(name, a_sp, device="cpu", runs=1)
    ja = J.CSR.from_scipy(a_sp)
    jc = J.spgemm(ja, ja, method="auto").to_scipy()
    jc.eliminate_zeros()
    assert row["verified"] is True
    assert row["flops"] == J.spgemm_flops(ja, ja)
    assert row["nnz_c"] == jc.nnz
    assert row["method"] == row["auto_method"] == J.choose_method(ja, ja)
    assert row["gflops"] > 0 and row["whole_call_ms"] > 0
    # off the card: no device memory and no roofline share
    assert row["peak_gib"] is None and row["bound_share"] is None


def test_headline_keys_and_where_it_writes(tmp_path, monkeypatch, capfd):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("BENCH_ONLY", "banded_16k,er_small_f64,"
                       "banded_16k_f64,rap_poisson2d_256")
    results = tmp_path / "out" / "results.jsonl"
    rc = bench.main(["--device", "cpu", "--results", str(results)])
    got = headline(capfd.readouterr().out)
    assert rc == 0
    assert set(got) == HEADLINE_KEYS
    assert got["metric"] == "spgemm_gflops_gmean_1chip"
    assert got["unit"] == "GFlops" and got["vs_baseline"] == got["value"]
    detail = got["detail"]
    assert DETAIL_KEYS <= set(detail)
    assert detail["failed"] == [] and detail["device"] is None
    assert detail["n_scored"] == 1 and detail["partial"] is True
    assert detail["banded_16k"] == got["value"] > 0
    for key in ("er_small_f64", "banded_16k_f64", "gmean_f64",
                "er_small_f64_vs_f32", "rap_poisson2d_256"):
        assert detail[key] > 0, key
    rows = [json.loads(x) for x in results.read_text().splitlines()]
    assert all(r["verified"] for r in rows)
    assert {r["matrix"] for r in rows} == {
        "banded_16k", "er_small_f64", "banded_16k_f64", "rap_poisson2d_256"}
    assert {r["method"] for r in rows if r["matrix"] == "rap_poisson2d_256"
            } >= {"triple", "aggrap"}
    # only the results file; the partial snapshot was removed at the end
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(tmp_path)) == ["cwd", "out"]
    assert os.listdir(tmp_path / "out") == ["results.jsonl"]


def test_failed_point_exits_1(tmp_path, monkeypatch, capfd):
    real = bench.spgemm_reference

    def wrong(a_sp, b_sp):
        c = real(a_sp, b_sp)
        c.data = c.data * 2
        return c

    monkeypatch.setattr(bench, "spgemm_reference", wrong)
    monkeypatch.setenv("BENCH_ONLY", "banded_16k")
    results = tmp_path / "results.jsonl"
    rc = bench.main(["--device", "cpu", "--results", str(results)])
    got = headline(capfd.readouterr().out)
    assert rc == 1
    assert got["detail"]["failed"] == ["banded_16k"]
    assert got["detail"]["n_scored"] == 0 and "banded_16k" not in got["detail"]
    (row,) = [json.loads(x) for x in results.read_text().splitlines()]
    assert row["verified"] is False and "value mismatch" in row["error"]


@pytest.mark.parametrize("pick,refused", [("hash", None),
                                          ("grouped", "make_grouped_plan"),
                                          ("tilepack", "make_tilepack_plan")])
def test_unrunnable_pick_fails_without_chunked(monkeypatch, pick, refused):
    import importlib

    monkeypatch.setattr(tdispatch, "choose_method", lambda a, b, *_: pick)
    if refused:
        module = importlib.import_module(
            f"benchmark_spgemm_using_csr_tpu_torch.ops.{pick}")
        monkeypatch.setattr(module, refused, lambda *a, **k: None)
    ran = []
    monkeypatch.setattr(tchunked, "spgemm_chunked",
                        lambda *a: ran.append(1))
    with pytest.raises(bench.PointFailed):
        bench.spgemm_point("er_small", jgen.SUITE["er_small"](),
                           device="cpu", runs=1)
    assert ran == []


def test_device_defaults_to_cuda(monkeypatch, capfd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
    assert capfd.readouterr().out == ""  # no headline


def test_unknown_point_is_refused(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_ONLY", "banded_16k,nope")
    with pytest.raises(SystemExit, match="nope"):
        bench.main(["--device", "cpu", "--results",
                    str(tmp_path / "r.jsonl")])


@pytest.mark.parametrize("elapsed,budget,runs,want", [
    (0.0, 0.0, 5, 5), (1e6, 0.0, 5, 5), (10.0, 100.0, 5, 5),
    (60.0, 100.0, 5, 3), (80.0, 100.0, 5, 1), (60.0, 100.0, 2, 2)])
def test_budget_trims_repeats(elapsed, budget, runs, want):
    assert bench.runs_for(elapsed, budget, runs) == want


def test_ooc_point_on_a_small_matrix(tmp_path, monkeypatch):
    """The out-of-core point's path (three calls, verified, the batched
    plan's roofline) on dense_rows_2k in place of dense_rows_8k."""
    monkeypatch.setattr(bench, "OOC_MATRIX", "dense_rows_2k")
    h = bench.Harness(device="cpu", results=str(tmp_path / "r.jsonl"),
                      only=[bench.OOC_POINT], say=lambda msg: None)
    h.run()
    assert h.failed == {}
    row = h.per_matrix[bench.OOC_POINT]
    a_sp = jgen.SUITE["dense_rows_2k"]()
    ja = J.CSR.from_scipy(a_sp)
    assert row["flops"] == J.spgemm_flops(ja, ja)
    assert row["nnz_c"] == (a_sp @ a_sp).nnz and row["verified"] is True
    assert len(row["walls_ms"]) == 3 and row["wall_ms"] == min(
        row["walls_ms"][1:])
    # excluded from the gmean
    assert h.headline()["detail"]["n_scored"] == 0


def test_sigterm_prints_a_partial_headline(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, BENCH_ONLY="rap_poisson2d_256")
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark_spgemm_using_csr_tpu_torch.bench",
         "--device", "cpu", "--results", str(tmp_path / "r.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        for text in proc.stderr:  # the handlers are in place by now
            if "started" in text:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 128 + signal.SIGTERM
    got = headline(out)
    assert set(got) == HEADLINE_KEYS and got["detail"]["partial"] is True


def test_verify_admits_only_cancelled_entries_off_structure():
    """The harness's check (utils/oracle.assert_csr_equal with the scipy
    operands): an entry in one structure only passes when its value lies
    within k * eps * sum|terms| of 0, k its count of terms."""
    import scipy.sparse as sp

    a = sp.csr_matrix(np.array([[1.0, 1.0, 0.0], [2.0, 0.0, 3.0]],
                               np.float32))
    b = sp.csr_matrix(np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                                [0.0, 1.0, 0.0]], np.float32))
    want = bench.spgemm_reference(a, b)  # C[0, 0] = 1 - 1 cancels: dropped
    assert want.nnz == 2
    tol, factors = bench.F32_TOL, (a, b)
    eps = float(np.finfo(np.float32).eps)
    assert bench.verify(T.CSR.from_scipy(want, device="cpu"), want, tol,
                        factors) == 0

    def with_entries(c, entries):
        c = c.tolil()
        for (i, j), v in entries.items():
            c[i, j] = v
        return T.CSR.from_scipy(c.tocsr(), device="cpu")

    # 2 terms of magnitude 1: bound 2 * eps * 2
    assert bench.verify(with_entries(want, {(0, 0): eps}), want, tol,
                        factors) == 1
    # within atol, but far past the sums' rounding bound
    with pytest.raises(AssertionError, match="structure mismatch"):
        bench.verify(with_entries(want, {(0, 0): 1e-5}), want, tol, factors)
    # an entry outside the product's structure, however small
    with pytest.raises(AssertionError, match="structure mismatch"):
        bench.verify(with_entries(want, {(0, 2): 1e-30}), want, tol, factors)
    # an entry of the product dropped
    with pytest.raises(AssertionError, match="structure mismatch"):
        bench.verify(with_entries(want, {(1, 0): 0.0}), want, tol, factors)
    with pytest.raises(AssertionError, match="value mismatch"):
        bench.verify(T.CSR.from_scipy(want * 2, device="cpu"), want, tol,
                     factors)


def test_fem_46k_cancellations_within_their_bound():
    """fem_46k's dia product (K3's plain version, bit-equal to K3) and
    scipy's each cancel one entry to exactly 0 that the other leaves as a
    residue: two entries in one structure only, each a small part of its
    rounding bound."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.dia import dia_spgemm
    from benchmark_spgemm_using_csr_tpu_torch.utils import oracle

    a_sp = jgen.SUITE["fem_46k"]()
    d = T.DIA.from_scipy(a_sp, device="cpu")
    got = oracle.canonical(dia_spgemm(d, d).to_csr(prune=True))
    got.eliminate_zeros()
    want = oracle.spgemm_reference(a_sp, a_sp)
    n = a_sp.shape[1]
    k_got, k_want = oracle._keys(got), oracle._keys(want)
    only_got = np.setdiff1d(k_got, k_want)
    only_want = np.setdiff1d(k_want, k_got)
    assert only_got.tolist() == [42341 * n + 46093]
    assert only_want.tolist() == [32944 * n + 29122]
    eps = float(np.finfo(np.float32).eps)
    # residues of 2^-23 and -2^-24 against bounds of 9 terms summing to
    # 6.947 in magnitude and 6 terms summing to 4.754: 1.6% and 1.8%
    for keys, c, residue, bound_want in (
            (only_got, got, 2.0 ** -23, 7.4535e-6),
            (only_want, want, -2.0 ** -24, 3.4004e-6)):
        bound = oracle.cancellation_bound((a_sp, a_sp), keys, n, eps)
        assert float(c[divmod(int(keys[0]), n)]) == residue
        assert bound[0] == pytest.approx(bound_want, rel=1e-4)
        assert abs(residue) < 0.02 * bound[0]
    assert bench.verify(T.CSR.from_scipy(got, device="cpu"), want,
                        bench.F32_TOL, (a_sp, a_sp)) == 2
