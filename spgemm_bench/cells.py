"""Finding a cell's pieces from the data alone.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and the metrics. Everything else is a file found by a name
in it, under the benchmark's folder:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
  module of ``drivers/`` that drives it;
- a cell's limits of the comparison: ``limits/<cell>.json``;
- a metric: ``metrics/<name>.py``, whose ``read(ctx)`` gives the number or
  None.

So a cell is added by adding files and entries, with no edit to a file
that is there.
"""
from __future__ import annotations

import importlib.util
import json
import os

PACKAGE = "spgemm_bench"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports (``end_to_end`` untraced, ``per_layer`` traced)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no cell {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    folder = os.path.join(root, PACKAGE)
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": w["config"],
        "traffic": w["traffic"],
        "config_data": _json(os.path.join(root, config["file"])),
        "traffic_data": _json(os.path.join(folder, "traffic",
                                           f"{w['traffic']}.json")),
        "limits": _json(os.path.join(folder, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
        "root": root,
    }


def reader(metric: str, root: str = ROOT):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, PACKAGE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
