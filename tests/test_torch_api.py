"""The PyTorch port's facade, dispatcher and CLI against the reference
package. Structures (rowptr, colidx, padding) equal exactly; values within
rtol 1e-4 / atol 1e-5 (float32 sums in another order)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu.ops import dispatch as jdispatch
from benchmark_spgemm_using_csr_tpu_torch import cli
from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch as tdispatch

torch.set_num_threads(2)

METHODS = ("auto", "chunked", "grouped", "tilepack", "bsr", "dia", "dense",
           "tiled", "fused", "esc", "binned", "hash")


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


AUTO = {
    "er_small": lambda: jgen.SUITE["er_small"](),
    "powerlaw_small": lambda: jgen.SUITE["powerlaw_small"](),
    "circuit": lambda: jgen.circuit(2048, seed=3),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_auto_same_csr_as_reference(name):
    ja = J.CSR.from_scipy(AUTO[name]())
    ta = bridge(ja)
    jcsr = J.spgemm(ja, ja, method="auto")
    tcsr = T.spgemm(ta, ta, method="auto")
    # trimmed buffers: the same capacity and the same zero padding
    np.testing.assert_array_equal(tcsr.rowptr.numpy(), np.asarray(jcsr.rowptr))
    np.testing.assert_array_equal(tcsr.colidx.numpy(), np.asarray(jcsr.colidx))
    np.testing.assert_allclose(tcsr.vals.numpy(), np.asarray(jcsr.vals),
                               rtol=1e-4, atol=1e-5)


# suite points at full size (choose_method is host-only numpy): the ESC
# points, bsr's and dense's, the block / stencil / hub regimes, and every
# other member the suite harness (bench.py) scores but the three with
# 400k-1M rows (tests/test_torch_bench_picks.py)
DISPATCH = ["er_small", "powerlaw_small", "poisson2d_64", "er_medium",
            "powerlaw_medium", "circuit_64k", "dense_rows_2k",
            "dense_rows_8k", "banded_16k", "stencil27_32", "hubrows_32k",
            "poisson2d_256", "econ_206k", "mc2depi_524k", "scircuit_256k",
            "fem_17k", "fem_32k", "pdb_8k", "femirr_17k",
            "pattern_circuit_64k", "fem_46k", "consph_83k"]
PICKS = {"dense_rows_2k": "bsr", "dense_rows_8k": "dense",
         "poisson2d_256": "dia", "mc2depi_524k": "dia", "fem_17k": "dia",
         "fem_32k": "dia", "pdb_8k": "dia", "fem_46k": "dia",
         "consph_83k": "dia", "econ_206k": "grouped",
         "scircuit_256k": "grouped", "femirr_17k": "grouped",
         "pattern_circuit_64k": "grouped"}


@pytest.mark.parametrize("name", DISPATCH)
def test_choose_method_agrees(name):
    ja = J.CSR.from_scipy(jgen.SUITE[name]())
    ta = bridge(ja)
    want = J.choose_method(ja, ja)
    assert T.choose_method(ta, ta) == want
    assert want == PICKS.get(name, want)


@pytest.mark.parametrize("name", ["dense_rows_2k", "dense_rows_8k",
                                  "banded_16k", "stencil27_32",
                                  "hubrows_32k", "er_small"])
def test_bsr_dense_hash_estimates_equal_reference(name):
    ja = J.CSR.from_scipy(jgen.SUITE[name]())
    ta = bridge(ja)
    for est in ("estimate_bsr_s", "estimate_dense_s", "estimate_hash_s"):
        want = getattr(jdispatch, est)(ja, ja)
        got = getattr(tdispatch, est)(ta, ta)
        if np.isinf(want):
            assert np.isinf(got), est
        else:
            assert got == pytest.approx(want, rel=1e-12), est


def test_auto_builds_the_tilepack_plan_once(monkeypatch):
    from benchmark_spgemm_using_csr_tpu_torch.ops import tilepack

    built = []
    real = tilepack.make_tilepack_plan
    monkeypatch.setattr(tilepack, "make_tilepack_plan",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    sa = jgen.erdos_renyi(16384, 16384, 12.0, seed=0)  # routed to tilepack
    ta = T.CSR.from_scipy(sa, device="cpu")
    plans = {}
    # the estimate prices the plan's statics without building it
    assert T.choose_method(ta, ta) == "tilepack"
    assert built == [] and "tilepack" not in plans
    assert T.api.resolve_method(ta, ta, plans) == "tilepack"
    assert len(built) == 1 and plans["tilepack"] is not None
    built.clear()
    c = T.spgemm(ta, ta, method="auto")
    assert len(built) == 1  # built once, after the pick
    want = (sa @ sa).tocsr()
    want.sort_indices()
    nnz = want.nnz
    np.testing.assert_array_equal(c.rowptr.numpy(), want.indptr)
    np.testing.assert_array_equal(c.colidx.numpy()[:nnz], want.indices)
    np.testing.assert_allclose(c.vals.numpy()[:nnz], want.data,
                               rtol=1e-4, atol=1e-5)


def test_auto_builds_the_grouped_plan_once(monkeypatch):
    from benchmark_spgemm_using_csr_tpu_torch.ops import grouped

    built = []
    real = grouped.make_grouped_plan
    monkeypatch.setattr(grouped, "make_grouped_plan",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    sa = jgen.SUITE["femirr_17k"]()  # routed to grouped
    ta = T.CSR.from_scipy(sa, device="cpu")
    plans = {}
    assert T.api.resolve_method(ta, ta, plans) == "grouped"
    assert len(built) == 1 and plans["grouped"] is not None
    built.clear()
    c = T.spgemm(ta, ta, method="auto")
    assert len(built) == 1
    want = (sa @ sa).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(c.rowptr.numpy(), want.indptr)


@pytest.mark.parametrize("pick,planner", [("tilepack", "make_tilepack_plan"),
                                          ("grouped", "make_grouped_plan")])
def test_auto_runs_chunked_where_the_plan_refuses(monkeypatch, pick, planner):
    """resolve_method is what spgemm(auto) runs: the pick, or chunked where
    tilepack's or grouped's plan refuses the operands; the forced method
    raises there."""
    import importlib

    from benchmark_spgemm_using_csr_tpu_torch.ops import chunked

    module = importlib.import_module(
        f"benchmark_spgemm_using_csr_tpu_torch.ops.{pick}")
    monkeypatch.setattr(tdispatch, "choose_method", lambda a, b, *_: pick)
    monkeypatch.setattr(module, planner, lambda *a, **k: None)
    ran = []
    real = chunked.spgemm_chunked
    monkeypatch.setattr(chunked, "spgemm_chunked",
                        lambda *a: ran.append(1) or real(*a))
    sa = jgen.SUITE["er_small"]()
    ta = T.CSR.from_scipy(sa, device="cpu")
    assert T.api.resolve_method(ta, ta) == "chunked"
    c = T.spgemm(ta, ta, method="auto")
    assert ran == [1]
    want = (sa @ sa).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(c.rowptr.numpy(), want.indptr)
    with pytest.raises(ValueError, match="outside"):
        T.spgemm(ta, ta, method=pick)


def test_choose_method_rectangular():
    sa, sb = jgen.rect_pair(600, 300, 500, seed=7)
    ja, jb = J.CSR.from_scipy(sa), J.CSR.from_scipy(sb)
    assert T.choose_method(bridge(ja), bridge(jb)) == J.choose_method(ja, jb)


def test_bad_calls_raise():
    a = T.CSR.from_scipy(jgen.poisson2d(8), device="cpu")
    b = T.CSR.from_scipy(jgen.poisson2d(4), device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        T.spgemm(a, a, method="nope")
    with pytest.raises(ValueError, match="inner dims"):
        T.spgemm(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cli_json_on_cpu(capsys, dtype):
    rc = cli.main(["suite:er_small", "--device", "cpu", "--json", "--runs",
                   "1", "--warmup", "0", "--dtype", dtype])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert record["device"] == "cpu" and record["dtype"] == dtype
    a = jgen.SUITE["er_small"]()
    assert record["nnz_a"] == a.nnz
    assert record["nnz_c"] == (a @ a).nnz
    assert record["nnz_ct"] == J.spgemm_flops(*(J.CSR.from_scipy(a),) * 2) // 2
    for key in ("matrix", "method", "m", "n", "mean_s", "min_s", "gflops",
                "gflops_best", "nnz_per_s"):
        assert key in record


@pytest.mark.parametrize("args", [
    ["--mesh", "2"], ["--roofline"], ["--dtype", "bfloat16"],
])
def test_cli_unported_options_exit(args, capsys):
    """Every option that once exited "not ported" (--mesh, --roofline,
    --dtype bfloat16) now runs to a verified record; --mesh 2 over two
    gloo ranks, as method dist/replicatedx2."""
    argv = ["suite:er_small", "--device", "cpu"] + args
    assert cli.main(argv + ["--json", "--runs", "1", "--warmup", "0"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["verified"] is True
    if args[0] == "--mesh":
        assert record["method"] == "dist/replicatedx2"


@pytest.mark.parametrize("method", ["dia", "tiled", "binned"])
def test_cli_slice_b_and_d_methods_on_cpu(capsys, method):
    rc = cli.main(["gen:poisson2d:24", "--device", "cpu", "--json", "--runs",
                   "1", "--warmup", "0", "--method", method])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert record["method"] == method and record["m"] == 24 * 24


@pytest.mark.parametrize("method", ["bsr", "dense", "hash", "fused"])
def test_cli_slice_c_and_d_methods_on_cpu(capsys, method):
    rc = cli.main(["gen:banded:256", "--device", "cpu", "--json", "--runs",
                   "1", "--warmup", "0", "--method", method])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert record["method"] == method and record["m"] == 256


@pytest.mark.parametrize("op", ["spmv", "spmm", "spadd", "sptrsv"])
def test_cli_ops_on_cpu(capsys, tmp_path, op):
    out = tmp_path / "results.jsonl"
    rc = cli.main(["gen:poisson2d:24", "--device", "cpu", "--json", "--runs",
                   "1", "--warmup", "0", "--op", op, "--spmm-k", "8",
                   "--out", str(out)])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert record["op"] == op and record["device"] == "cpu"
    assert record["m"] == record["n"] == 24 * 24
    for key in ("mean_s", "min_s", "gflops"):
        assert key in record
    if op == "sptrsv":
        assert record["n_levels"] >= 1 and record["n_steps"] >= 1
    written = json.loads(out.read_text().splitlines()[-1])
    assert written["op"] == op and "ts" in written


def test_cli_text_output_of_an_op(capsys):
    rc = cli.main(["gen:poisson2d:12", "--device", "cpu", "--runs", "1",
                   "--warmup", "0", "--op", "sptrsv"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0 and line.startswith("sptrsv: gen:poisson2d:12")
    assert "levels" in line and line.endswith("verify PASS")


def test_cli_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["suite:er_small"])


def test_cli_accepts_every_reference_method():
    from benchmark_spgemm_using_csr_tpu import cli as jcli

    def choices(parser, flag):
        return next(a.choices for a in parser._actions
                    if flag in a.option_strings)

    for flag in ("--method", "--op", "--dtype"):
        assert choices(cli.build_parser(), flag) == choices(
            jcli.build_parser(), flag)
    assert tuple(choices(cli.build_parser(), "--method")) == METHODS


NEW_MODULES = ("compat", "ops.bsr", "ops.dense", "ops.hash", "ops.fused",
               "ops.batched", "ops.spmv", "ops.spadd", "ops.sptrsv",
               "parallel.dist", "native.levels", "utils.results")


def test_import_pulls_in_no_jax():
    imports = "; ".join(f"import benchmark_spgemm_using_csr_tpu_torch.{m}"
                        for m in NEW_MODULES)
    code = (f"import sys, benchmark_spgemm_using_csr_tpu_torch as p; "
            f"{imports}; "
            "p.spgemm; print(sorted(m for m in sys.modules "
            "if m in ('jax', 'benchmark_spgemm_using_csr_tpu') "
            "or m.startswith(('jax.', 'benchmark_spgemm_using_csr_tpu.'))))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=repo)
    assert out.stdout.strip() == "[]"
