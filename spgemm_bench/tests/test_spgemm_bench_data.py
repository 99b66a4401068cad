"""The benchmark is driven by data: cells, configurations, traffic, limits
and metrics are found by name, and a cell is added as new files alone."""
import importlib
import json
import os
import re
import shutil
import sys
import types

import numpy as np
import pytest

from spgemm_bench import cells, harness

BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spgemm_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "spgemm_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("spgemm_bench/")
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted({c["name"] for c in BENCH["configs"]}))
def test_every_configurations_generator_declares_its_small_size(name):
    """Each configuration's generator module has ``generate`` and the
    CPU-test size ``SMALL_PARAMS``, with which it makes a small matrix."""
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    with open(os.path.join(cells.ROOT, entry["file"])) as f:
        config = json.load(f)
    gen = importlib.import_module(
        f"spgemm_bench.generators.{config['generator']}")
    assert callable(gen.generate)
    assert isinstance(gen.SMALL_PARAMS, dict)
    assert set(gen.SMALL_PARAMS) <= set(config["params"])
    rowptr, colidx, vals, shape = gen.generate(**gen.SMALL_PARAMS)
    assert 0 < shape[0] <= 4096 and rowptr[-1] == colidx.size == vals.size


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_from_the_data(name):
    cell = cells.load(name)
    assert cell["config_data"]["name"] == cell["config"]
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert cell["config_data"]["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(
        cells.ROOT, "spgemm_bench", "drivers",
        cell["traffic_data"]["driver"] + ".py"))
    assert cell["limits"]["struct_mismatch"] == 0
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(cells.reader(m["name"]))
    moved = {m["moves"] for m in cell["per_layer"]}
    assert moved <= set(e2e)


def test_an_unknown_cell_is_refused():
    with pytest.raises(ValueError, match="no cell"):
        cells.load("no_such.cell")


def test_a_cell_is_added_as_new_files_alone(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, as new
    files and new entries, run with no edit to a file that is there."""
    from conftest import make_small_root

    root = make_small_root(tmp_path)
    pkg = os.path.join(root, "spgemm_bench")
    with open(os.path.join(pkg, "configs", "poisson2d_tiny.json"), "w") as f:
        json.dump({"name": "poisson2d_tiny", "generator": "poisson2d",
                   "params": {"k": 16}, "dtype": "float32", "reduced": []},
                  f)
    with open(os.path.join(pkg, "traffic", "reuse_few.json"), "w") as f:
        json.dump({"driver": "reuse", "value_sets": 2, "spread": 0.25,
                   "sample": 2, "trace_seconds": 1}, f)
    with open(os.path.join(pkg, "limits", "poisson2d_tiny.reuse_few.json"),
              "w") as f:
        json.dump({"struct_mismatch": 0, "val_err": 1e-4}, f)
    with open(os.path.join(pkg, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.calls)\n")
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "poisson2d_tiny", "source": "a test",
        "file": "spgemm_bench/configs/poisson2d_tiny.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "poisson2d_tiny.reuse_few", "config": "poisson2d_tiny",
        "traffic": "reuse_few", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:  # the steady cells' metrics
        if m["name"] in ("gflops", "call_ms_p95", "peak_gib"):
            m["workloads"].append("poisson2d_tiny.reuse_few")
    bench["per_layer"].append({
        "name": "calls_seen", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "gflops",
        "workloads": ["poisson2d_tiny.reuse_few"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = cells.load("poisson2d_tiny.reuse_few", root)
    traced = harness.run(cell, 7, 0.2, True, "cpu")
    assert traced["correct"] and traced["metrics"]["calls_seen"]["value"] > 0
    plain = harness.run(cell, 7, 0.2, False, "cpu")
    assert plain["correct"] and "gflops" in plain["metrics"]


def _banded(n: int, half_width: int):
    """A generator the package does not have: a band of positive values,
    as host arrays in canonical CSR order."""
    import scipy.sparse as sp

    rng = np.random.default_rng(n)
    offsets = range(-half_width, half_width + 1)
    mat = sp.diags([1.0 + rng.random(n - abs(o)) for o in offsets],
                   list(offsets), shape=(n, n), format="csr")
    mat = mat.astype(np.float32)
    mat.sort_indices()
    return mat.indptr, mat.indices, mat.data, (n, n)


def test_a_config_with_a_generator_of_its_own_is_added_as_new_files_alone(
        tmp_path, monkeypatch):
    """A configuration whose generator module is new (here put in
    ``sys.modules`` as the file would be found), with its limits and its
    cell, as new files and entries of a full-size checkout: the small root
    cuts it, and every other configuration, to its generator's own
    ``SMALL_PARAMS``, and its cell runs, traced and plain."""
    from conftest import DATA, make_small_root, small_params

    gen = types.ModuleType("spgemm_bench.generators.banded_test")
    gen.generate = _banded
    gen.SMALL_PARAMS = {"n": 300, "half_width": 2}
    monkeypatch.setitem(sys.modules, gen.__name__, gen)
    source = tmp_path / "checkout"
    pkg = source / "spgemm_bench"
    for d in DATA:
        shutil.copytree(os.path.join(cells.ROOT, "spgemm_bench", d),
                        pkg / d)
    (pkg / "configs" / "banded_big.json").write_text(json.dumps({
        "name": "banded_big", "generator": "banded_test",
        "params": {"n": 10**7, "half_width": 2}, "dtype": "float32",
        "reduced": []}))
    (pkg / "limits" / "banded_big.reuse.json").write_text(json.dumps(
        {"struct_mismatch": 0, "val_err": 1e-4}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "banded_big", "source": "a test",
        "file": "spgemm_bench/configs/banded_big.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "banded_big.reuse", "config": "banded_big",
        "traffic": "reuse", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # the steady class
        if "circuit_262k.reuse" in m.get("workloads", []):
            m["workloads"].append("banded_big.reuse")
    (source / "BENCHMARK.json").write_text(json.dumps(bench))
    root = make_small_root(tmp_path / "small", str(source))
    for w in bench["workloads"]:
        config = cells.load(w["name"], root)["config_data"]
        assert config["params"] == small_params(config["generator"])
    cell = cells.load("banded_big.reuse", root)
    assert cell["config_data"]["params"] == gen.SMALL_PARAMS
    traced = harness.run(cell, 2**31 + 9, 0.2, True, "cpu")
    assert traced["correct"] and "graphs.captures" in traced["metrics"]
    plain = harness.run(cell, 2**31 + 9, 0.2, False, "cpu")
    assert plain["correct"] and "gflops" in plain["metrics"]
