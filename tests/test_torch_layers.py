"""The port's layering, read from its sources with ``ast`` (imports inside
functions count too):

- no ``ops/`` module imports a layer above it: ``parallel``, ``models``,
  ``api``, ``cli``, ``bench``, ``scripts`` or ``utils.roofline``;
- ``ops/stream.py``, the product stream's shared primitives, imports
  nothing else of ``ops``;
- the imports among ``ops/`` modules form no cycle."""
import ast
import pathlib

import pytest

PKG_NAME = "benchmark_spgemm_using_csr_tpu_torch"
PKG = pathlib.Path(__file__).resolve().parents[1] / PKG_NAME
OPS = PKG / "ops"
ABOVE_OPS = ("parallel", "models", "api", "cli", "bench", "scripts",
             "utils.roofline")


def imports_of(path: pathlib.Path) -> set:
    """Every name a module imports, dotted from the package root: ``from
    .stream import scatter`` in ``ops/chunked.py`` gives ``ops.stream`` and
    ``ops.stream.scatter``, ``from ..utils import roofline`` gives
    ``utils`` and ``utils.roofline``."""
    here = list(path.relative_to(PKG).parent.parts)
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = here[: len(here) - (node.level - 1)]
            elif (node.module or "").split(".")[0] == PKG_NAME:
                base = []
            else:
                continue
            mod = base + [p for p in (node.module or "").split(".") if p]
            if node.level == 0:
                mod = mod[1:]
            if mod:
                out.add(".".join(mod))
            out.update(".".join(mod + [a.name]) for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == PKG_NAME and len(parts) > 1:
                    out.add(".".join(parts[1:]))
    return out


def ops_modules() -> dict:
    """{module stem: the set of names it imports} over ``ops/*.py``."""
    return {p.stem: imports_of(p) for p in sorted(OPS.glob("*.py"))}


def ops_graph() -> dict:
    """{module stem: the ``ops`` modules it imports}."""
    stems = {p.stem for p in OPS.glob("*.py")}
    return {
        mod: {name.split(".")[1] for name in names
              if name.startswith("ops.") and name.split(".")[1] in stems
              and name.split(".")[1] != mod}
        for mod, names in ops_modules().items()
    }


def upward_imports() -> list:
    return sorted(
        f"ops/{mod}.py imports {name}"
        for mod, names in ops_modules().items() for name in names
        if any(name == up or name.startswith(up + ".") for up in ABOVE_OPS))


def stream_imports_of_ops() -> list:
    return sorted(ops_graph()["stream"])


def ops_cycles() -> list:
    """One cycle of every strongly connected part found by a depth-first
    walk, as module stems."""
    graph = ops_graph()
    state, stack, found = {}, [], []

    def walk(mod):
        state[mod] = "open"
        stack.append(mod)
        for dep in sorted(graph[mod]):
            if state.get(dep) == "open":
                found.append(stack[stack.index(dep):] + [dep])
            elif dep not in state:
                walk(dep)
        stack.pop()
        state[mod] = "done"

    for mod in sorted(graph):
        if mod not in state:
            walk(mod)
    return found


RULES = {
    "no_upward_import": upward_imports,
    "stream_is_the_bottom": stream_imports_of_ops,
    "no_cycle_among_ops": ops_cycles,
}


def test_the_walk_sees_imports():
    """The walker reads relative, lazy and ``from . import`` forms."""
    graph = ops_graph()
    assert "stream" in graph["chunked"]  # from .stream import (...)
    assert "graphs" in graph["chunked"]  # from . import graphs, in a body
    assert "grouped" in graph["dispatch"]  # lazy, inside a function
    assert "utils.profiling" in ops_modules()["chunked"]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_ops_layering(rule):
    assert RULES[rule]() == []
