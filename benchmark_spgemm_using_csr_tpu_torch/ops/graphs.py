"""One CUDA graph per static plan: the port's counterpart of the reference
package's ``jax.jit(..., static_argnames=("plan",))``.

The reference package compiles each planned numeric phase once per static
plan and replays the executable for any operand arrays of the same shapes.
``run(fn, plan, *args)`` does the same on the card with a CUDA graph:

- **Key**: the function, the plan (a frozen dataclass of ints and bools,
  so equal plans hash equal: a Python int the reference makes static,
  such as a width, a capacity or a sweep count, goes in through it), the
  device, and the (shape, dtype) of every tensor argument (a ``CSR`` or
  ``BSR`` contributes its three buffers and its shape). A scalar the
  reference traces, such as spadd's alpha, is a 0-d tensor argument, so
  another value replays the same graph.
  The schedule's device tensors are arguments, not part of the key, so
  the row blocks of the out-of-core path, planned under one set of
  statics, share one graph.
- **First call** with a key runs the eager body, as before: a one-shot
  caller (``spgemm(auto)`` on a fresh matrix) pays no warm-up, capture or
  instantiation.
- **Second call** captures: static input tensors take copies of the
  arguments, the caching allocator's cache is emptied, one eager warm-up
  runs on a side stream (it also builds a hand-written kernel before any
  capture), then ``torch.cuda.graph`` records the body (it empties the
  cache again as it begins), and the graph replays once for this call.
  The side stream cannot reuse the blocks the first call left cached on
  the caller's stream, so without the first emptying a large body's
  warm-up would stack on them up to the card's memory.
- **Later calls** copy the arguments into the static inputs, replay, and
  return clones of the outputs: the reference returns fresh arrays, so a
  C the caller holds survives the next call.

Every graph on a device is captured into one memory pool, that of a
cached graph. Replays run one after another on the caller's stream and
their outputs are cloned at once, so one graph's temporaries may reuse
another's: the pool holds the largest body's temporaries and the cached
graphs' outputs, not the sum of their peaks.

**Cache policy.** What a graph holds on its own is its static inputs and
outputs (``Graph.nbytes``); its temporaries lie in the shared pool. The
cache is bounded by those bytes: at most ``MAX_GRAPH_BYTES`` of them,
least recently used first out. A graph that leaves frees its inputs and
outputs, and its key is retired: it runs the eager body from then on, so
a cycle over more keys than the budget holds captures each key once, not
on every call. ``clear()`` drops every graph and forgets every key; the
pool goes back to PyTorch's caching allocator with the last graph, and the
allocator returns it to the device at ``torch.cuda.empty_cache()`` or
when an allocation would otherwise fail. Under ``with eager():`` every
call runs the eager body, whatever the cache holds (a measurement of the
eager call beside the replay).

CPU tensors, and any other device but CUDA, run the eager body: that is
what the caller asked for. On CUDA a capture or a replay that fails
raises; nothing falls back to the eager body.

A replay runs no Python, so the hand-written kernels' launch counters
(``ops/kernels``, ``ops/dia_kernels``, ``ops/dia_convert``) would not
move: each graph records at capture how many launches of each kernel it
holds, and every replay adds them to the counters.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from ..sparse.csr import BSR, CSR
from ..utils import profiling

# The static inputs and outputs the cached graphs may hold. One AMG
# hierarchy's numeric refresh (a graph per coarse level: 9 on
# mc2depi_524k's unsmoothed setup) and the four planned ESC methods on
# the suite's large points hold 0.67 GiB together (chip_smoke.py phase
# 19), so they fit with room for more; the temporaries of the largest
# body (~5 GiB on those points) lie in the shared pool beside it.
MAX_GRAPH_BYTES = 4 << 30
# keys called once on the card (a capture waits for a second call), and
# keys whose graph left the cache (they run eager until ``clear()``)
MAX_SEEN = 256


class LRU:
    """A bounded map, least recently used first out: the ``size(value)``
    of the values it holds add up to at most ``cap`` (a value larger than
    ``cap`` alone stays alone). ``on_evict(value)`` runs for every value
    that leaves (eviction, ``pop`` or ``clear``)."""

    def __init__(self, cap: int, on_evict=None, size=lambda value: 1):
        self.cap = cap
        self.on_evict = on_evict
        self.size = size
        self.total = 0
        self._items: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key) -> bool:
        return key in self._items

    def values(self) -> list:
        return list(self._items.values())

    def get(self, key):
        """The value stored under ``key`` (now the most recent), or None."""
        if key not in self._items:
            return None
        self._items.move_to_end(key)
        return self._items[key]

    def put(self, key, value) -> None:
        self.pop(key)
        self.trim(self.cap - self.size(value))
        self._items[key] = value
        self.total += self.size(value)

    def trim(self, n: int) -> None:
        """Evict the least recent values until their sizes add up to at
        most ``n``."""
        while self._items and self.total > n:
            self._leave(self._items.popitem(last=False)[1])

    def pop(self, key) -> None:
        if key in self._items:
            self._leave(self._items.pop(key))

    def clear(self) -> None:
        self.trim(-1)

    def _leave(self, value) -> None:
        self.total -= self.size(value)
        if self.on_evict is not None:
            self.on_evict(value)


def _describe(x, leaves: list):
    """A hashable description of ``x`` with its tensors replaced by
    (shape, dtype); the tensors are appended to ``leaves`` in order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, CSR):
        return ("CSR", tuple(x.shape), _describe(x.rowptr, leaves),
                _describe(x.colidx, leaves), _describe(x.vals, leaves))
    if isinstance(x, BSR):
        return ("BSR", tuple(x.shape), _describe(x.rowptr, leaves),
                _describe(x.colidx, leaves), _describe(x.blocks, leaves))
    if isinstance(x, tuple):
        return ("tuple",) + tuple(_describe(y, leaves) for y in x)
    raise TypeError(f"no graph argument of type {type(x).__name__}")


def _rebuild(desc, tensors):
    """The inverse of ``_describe``: ``desc`` with tensors taken in order
    from the iterator ``tensors``."""
    kind = desc[0]
    if kind == "tensor":
        return next(tensors)
    if kind in ("CSR", "BSR"):
        cls = CSR if kind == "CSR" else BSR
        return cls(_rebuild(desc[2], tensors), _rebuild(desc[3], tensors),
                   _rebuild(desc[4], tensors), desc[1])
    return tuple(_rebuild(d, tensors) for d in desc[1:])


def cache_key(fn, plan, *args):
    """(key, tensors): the cache key of ``fn(*args, plan)`` and the tensor
    arguments in order. Raises TypeError for an unhashable plan."""
    leaves: list = []
    desc = _describe(args, leaves)
    devices = {t.device for t in leaves}
    if len(devices) > 1:
        raise ValueError(
            f"arguments on several devices: {sorted(map(str, devices))}")
    device = leaves[0].device if leaves else torch.device("cpu")
    key = (fn, plan, device, desc)
    hash(key)
    return key, leaves


def _counted():
    """The hand-written kernels' wrappers, whose ``launches`` count."""
    from . import dia_convert, dia_kernels, kernels, rowlocal, symbolic

    return {"tile_sort_merge": kernels.tile_sort_merge,
            "bin_sort_compress": kernels.bin_sort_compress,
            "dia_spgemm_fused": dia_kernels.dia_spgemm_fused,
            "dia_to_csr": dia_convert.dia_to_csr,
            "symbolic_count": symbolic.nnz_rows,
            "rowlocal_esc": rowlocal.rowlocal_esc}


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


class Graph:
    """One captured body: its key, static inputs and outputs, the pool it
    was captured into, the launches of each counted kernel it holds, and
    its capture time."""

    def __init__(self, fn, plan, key, tensors, pool=None):
        self.name = getattr(fn, "__qualname__", repr(fn))
        self.key = key
        self.device = device = key[2]
        self.replays = 0
        with torch.cuda.device(device):
            self.static_in = [torch.empty(t.shape, dtype=t.dtype,
                                          device=device) for t in tensors]
            self._copy_in(tensors)
            args = _rebuild(key[3], iter(self.static_in))
            # warm-up on a side stream (PyTorch's capture recipe), not
            # beside the caller stream's cached blocks (module docstring)
            torch.cuda.empty_cache()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*args, plan)
            torch.cuda.current_stream().wait_stream(side)
            wrappers = _counted()
            before = {k: w.launches for k, w in wrappers.items()}
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    out = fn(*args, plan)
            finally:
                # a capture records launches without making them
                self.launches = {k: w.launches - before[k]
                                 for k, w in wrappers.items()}
                for k, w in wrappers.items():
                    w.launches = before[k]
            self.capture_s = time.perf_counter() - t0
        self.pool = self.graph.pool()
        self.static_out: list = []
        self.out_desc = _describe(out, self.static_out)
        self.in_bytes = _nbytes(self.static_in)
        self.out_bytes = _nbytes(self.static_out)
        # what the cache's budget counts (module docstring)
        self.nbytes = self.in_bytes + self.out_bytes

    def _copy_in(self, tensors) -> None:
        for s, t in zip(self.static_in, tensors):
            s.copy_(t)

    def replay(self, tensors):
        """The body's outputs for ``tensors``, as fresh clones."""
        with torch.cuda.device(self.device):
            self._copy_in(tensors)
            self.graph.replay()
            self.replays += 1
            profiling.count("graphs.copy_bytes",
                            self.in_bytes + self.out_bytes)
            for k, w in _counted().items():
                w.launches += self.launches[k]
            return _rebuild(self.out_desc,
                            (t.clone() for t in self.static_out))

    def release(self) -> None:
        """Free the outputs and inputs, then the graph (the shared pool
        goes with the last graph that uses it)."""
        self.static_out.clear()
        self.static_in.clear()
        self.graph.reset()

    def info(self) -> dict:
        return {"fn": self.name, "capture_ms": self.capture_s * 1e3,
                "replays": self.replays, "launches": dict(self.launches),
                "in_bytes": self.in_bytes, "out_bytes": self.out_bytes}


def _evict(graph) -> None:
    graph.release()
    _retired.put(graph.key, True)


_graphs = LRU(MAX_GRAPH_BYTES, on_evict=_evict, size=lambda g: g.nbytes)
_seen = LRU(MAX_SEEN)
_retired = LRU(MAX_SEEN)
_eager = False
# captures since the last clear()
captures = 0


def run(fn, plan, *args):
    """``fn(*args, plan)``: the eager body off CUDA, on a key's first call
    and once its graph has left the cache; a captured graph's replay from
    the second call on (module docstring)."""
    key, tensors = cache_key(fn, plan, *args)
    graph = None
    if key[2].type == "cuda" and not _eager:
        graph = _lookup(key, lambda pool: Graph(fn, plan, key, tensors, pool))
    if graph is None:
        with profiling.span("graphs.eager"):
            return fn(*args, plan)
    with profiling.span("graphs.replay"):
        return graph.replay(tensors)


def _lookup(key, capture):
    """The cached graph of ``key``, or a new one from ``capture(pool)`` on
    the key's second call, or None: run the eager body (the key's first
    call, or a retired key)."""
    global captures
    graph = _graphs.get(key)
    if graph is not None or key in _retired:
        return graph
    if key not in _seen:
        _seen.put(key, True)
        return None
    _seen.pop(key)
    pool = next((g.pool for g in _graphs.values() if g.device == key[2]),
                None)
    with profiling.span("graphs.capture"):
        graph = capture(pool)
    captures += 1
    _graphs.put(key, graph)
    return graph


@contextlib.contextmanager
def eager():
    """Within the block, every ``run`` runs the eager body; the cache is
    left as it is."""
    global _eager
    was, _eager = _eager, True
    try:
        yield
    finally:
        _eager = was


def pool_bytes() -> int:
    """The bytes the cached graphs' pools hold on their devices."""
    pools = {(g.device.index, tuple(g.pool)) for g in _graphs.values()}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if (seg["device"], tuple(seg["segment_pool_id"])) in pools)


def info() -> dict:
    """The captures since ``clear()``, the retired keys, the bytes of the
    graphs' pools and of their own inputs and outputs, and each cached
    graph's ``info()``, least recently used first."""
    return {"captures": captures, "retired": len(_retired),
            "pool_bytes": pool_bytes(), "graph_bytes": _graphs.total,
            "graphs": [g.info() for g in _graphs.values()]}


def clear() -> None:
    """Drop every graph and forget every key; the pools go back to the
    caching allocator (module docstring)."""
    global captures
    _graphs.clear()
    _seen.clear()
    _retired.clear()
    captures = 0
