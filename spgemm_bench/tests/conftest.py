"""The benchmark's own tests: ``python -m pytest spgemm_bench/tests -q``.

They run on the CPU at small sizes; tests marked ``cuda`` need a card and
skip without one (decided inside the ``card`` fixture, never at import).
``small_root`` is a copy of the benchmark's data (``BENCHMARK.json``,
configurations, traffic, limits, metrics) whose configurations are cut to
a size a test can hold, the ``SMALL_PARAMS`` that each configuration's
generator module declares; the code is the package's own.
"""
import importlib
import json
import os
import shutil

import pytest

from spgemm_bench import cells

DATA = ("configs", "traffic", "limits", "metrics")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def small_params(generator: str) -> dict:
    """The CPU-test size that generator module ``generator`` declares."""
    return importlib.import_module(
        f"{cells.PACKAGE}.generators.{generator}").SMALL_PARAMS


def make_small_root(path, source: str = cells.ROOT) -> str:
    """A checkout-like root holding the benchmark's data of the root
    ``source`` with every configuration cut to its generator's small
    size."""
    root = str(path)
    for d in DATA:
        shutil.copytree(os.path.join(source, cells.PACKAGE, d),
                        os.path.join(root, cells.PACKAGE, d))
    bench = cells.benchmark(source)
    for c in bench["configs"]:
        f = os.path.join(root, c["file"])
        with open(f) as fh:
            cfg = json.load(fh)
        cfg["params"] = small_params(cfg["generator"])
        with open(f, "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("small_root"))


@pytest.fixture
def card():
    """The card's device name; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
