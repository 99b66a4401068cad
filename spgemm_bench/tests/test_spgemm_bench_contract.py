"""The run's contract: its last line, its refusals, and what it may load."""
import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from spgemm_bench import cells, harness

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
PKG = os.path.join(cells.ROOT, cells.PACKAGE)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
FORBIDDEN = {"jax", "jaxlib", "flax", "benchmark_spgemm_using_csr_tpu"}
PORT = "benchmark_spgemm_using_csr_tpu_torch"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_last_line_has_the_contracts_keys(small_root, name, trace):
    cell = cells.load(name, small_root)
    r = harness.run(cell, 2**31 + 3, 0.2, bool(trace), "cpu")
    assert set(r) == KEYS | ({"breakdown"} if trace else set())
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    wanted = {m["name"] for m in cell["per_layer" if trace else
                                       "end_to_end"]}
    assert set(r["metrics"]) <= wanted
    if not trace:  # off the card: no peak memory
        assert set(r["metrics"]) == {m for m in wanted
                                     if not m.endswith("peak_gib")}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    line = json.dumps(harness.finite(r), allow_nan=False)
    assert json.loads(line)["correct"] is True


def test_no_card_exits_non_zero_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_alone_it_exits_non_zero_and_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), the run fails and prints no result."""
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / cells.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "spgemm_bench", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_like_but_not_jax",
                        types.ModuleType("jax_like_but_not_jax"))
    monkeypatch.setitem(sys.modules, PORT + ".fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax"]


def _imports(path: str) -> set:
    """Top-level names of the absolute imports of one source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: str) -> list:
    return [os.path.join(d, f) for d, _, fs in os.walk(folder)
            for f in fs if f.endswith(".py")]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(PKG):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG, "reference")):
        assert PORT not in _imports(path), path
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):  # relative imports stay inside it
            if isinstance(node, ast.ImportFrom):
                assert node.level in (0, 1), path
    code = ("import sys, spgemm_bench.reference.amg, "
            "spgemm_bench.reference.compare;"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {PORT})!r}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_run_of_every_cell_loads_neither_jax_nor_the_jax_package(
        small_root):
    code = (
        "import sys\n"
        "from spgemm_bench import cells, harness\n"
        f"for name in {CELLS!r}:\n"
        f"    r = harness.run(cells.load(name, {small_root!r}), 5, 0.1,\n"
        "                    name.endswith('oneshot'), 'cpu')\n"
        "    assert r['correct'], name\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_trace_leaves_the_copies_of_kept_outputs_out():
    """The window's length, busy time and idle gaps leave out the copies of
    sampled outputs (``KEEP``); the device's union is not a sum."""
    from spgemm_bench import trace

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    events = [
        ev(trace.WINDOW, "user_annotation", 0, 1000),
        ev(trace.CALL, "user_annotation", 0, 400),
        ev("k1", "kernel", 100, 200),
        ev("k2", "kernel", 150, 200),  # overlaps k1: union 100..350
        ev(trace.KEEP, "user_annotation", 400, 300),
        ev("Memcpy DtoH", "gpu_memcpy", 450, 200),
        ev(trace.CALL, "user_annotation", 700, 300),
        ev("k1", "kernel", 800, 100),
        ev("aten::sort", "cpu_op", 700, 100),
    ]
    p = trace.reduce({"traceEvents": events})
    assert p.window_s == pytest.approx(700e-6)
    assert p.busy_s == pytest.approx(350e-6)
    assert p.call_busy_s == pytest.approx(350e-6)
    assert [n for n, _ in p.device_ops] == ["k1", "k2"]
    assert sum(s for _, s in p.idle_gaps) == pytest.approx(350e-6)
    assert dict(p.idle_gaps)["aten::sort"] == pytest.approx(100e-6)
