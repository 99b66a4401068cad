"""One CUDA graph per static plan: the port's counterpart of the reference
package's ``jax.jit(..., static_argnames=("plan",))``.

The reference package compiles each planned numeric phase once per static
plan and replays the executable for any operand arrays of the same shapes.
``run(fn, plan, *args)`` does the same on the card with a CUDA graph:

- **Key**: the function, the plan (a frozen dataclass of ints and bools,
  so equal plans hash equal), the device, and the (shape, dtype) of every
  tensor argument (a ``CSR`` contributes its three buffers and its shape).
  The schedule's device tensors are arguments, not part of the key, so
  the row blocks of the out-of-core path, planned under one set of
  statics, share one graph.
- **First call** with a key runs the eager body, as before: a one-shot
  caller (``spgemm(auto)`` on a fresh matrix) pays no warm-up, capture or
  instantiation.
- **Second call** captures: static input tensors take copies of the
  arguments, one eager warm-up runs on a side stream (it also builds a
  hand-written kernel before any capture), then ``torch.cuda.graph``
  records the body (it empties the caching allocator's cache as it
  begins, once per plan), and the graph replays once for this call.
- **Later calls** copy the arguments into the static inputs, replay, and
  return clones of the outputs: the reference returns fresh arrays, so a
  C the caller holds survives the next call.

Every graph on a device is captured into one memory pool, that of a
cached graph. Replays run one after another on the caller's stream and
their outputs are cloned at once, so one graph's temporaries may reuse
another's: the pool holds the largest body's temporaries and the cached
graphs' outputs, not the sum of their peaks. The cache holds
``MAX_GRAPHS`` entries, least recently used first out; an entry that
leaves frees its inputs and outputs, and the pool goes back to PyTorch's
caching allocator with the last graph (``clear()`` drops them all). The
allocator returns it to the device at ``torch.cuda.empty_cache()`` or
when an allocation would otherwise fail.

CPU tensors, and any other device but CUDA, run the eager body: that is
what the caller asked for. On CUDA a capture or a replay that fails
raises; nothing falls back to the eager body.

A replay runs no Python, so the hand-written kernels' launch counters
(``ops/kernels``, ``ops/dia_kernels``) would not move: each graph records
at capture how many launches of each kernel it holds, and every replay
adds them to the counters.
"""
from __future__ import annotations

import collections
import time

import torch

from ..sparse.csr import CSR

# Four graphs: one of each planned ESC method a caller alternates between,
# or the two products of a chained R·A·P beside the two triangular solves
# of an exact-ILU0 preconditioner. They share one pool (module docstring),
# which an ESC body's temporaries take to ~5 GiB on the suite's largest
# points.
MAX_GRAPHS = 4
# keys called once on the card (a capture waits for a second call)
MAX_SEEN = 64


class LRU:
    """A bounded map, least recently used first out; ``on_evict(value)``
    runs for every value that leaves (eviction, ``pop`` or ``clear``)."""

    def __init__(self, cap: int, on_evict=None):
        self.cap = cap
        self.on_evict = on_evict
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
        self.trim(self.cap - 1)
        self._items[key] = value

    def trim(self, n: int) -> None:
        """Evict the least recent values until at most ``n`` stay."""
        while len(self._items) > n:
            self._leave(self._items.popitem(last=False)[1])

    def pop(self, key) -> None:
        if key in self._items:
            self._leave(self._items.pop(key))

    def clear(self) -> None:
        while self._items:
            self._leave(self._items.popitem(last=False)[1])

    def _leave(self, value) -> None:
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
    if isinstance(x, tuple):
        return ("tuple",) + tuple(_describe(y, leaves) for y in x)
    raise TypeError(f"no graph argument of type {type(x).__name__}")


def _rebuild(desc, tensors):
    """The inverse of ``_describe``: ``desc`` with tensors taken in order
    from the iterator ``tensors``."""
    kind = desc[0]
    if kind == "tensor":
        return next(tensors)
    if kind == "CSR":
        return CSR(_rebuild(desc[2], tensors), _rebuild(desc[3], tensors),
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
    from . import dia_kernels, kernels

    return {"tile_sort_merge": kernels.tile_sort_merge,
            "bin_sort_compress": kernels.bin_sort_compress,
            "dia_spgemm_fused": dia_kernels.dia_spgemm_fused}


class Graph:
    """One captured body: its static inputs and outputs, the launches of
    each counted kernel it holds, and its capture time."""

    def __init__(self, fn, plan, device, desc, tensors, pool=None):
        self.name = getattr(fn, "__qualname__", repr(fn))
        self.device = device
        self.replays = 0
        with torch.cuda.device(device):
            self.static_in = [torch.empty(t.shape, dtype=t.dtype,
                                          device=device) for t in tensors]
            self._copy_in(tensors)
            args = _rebuild(desc, iter(self.static_in))
            # warm-up on a side stream (PyTorch's capture recipe)
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
        self.static_out: list = []
        self.out_desc = _describe(out, self.static_out)

    def _copy_in(self, tensors) -> None:
        for s, t in zip(self.static_in, tensors):
            s.copy_(t)

    def replay(self, tensors):
        """The body's outputs for ``tensors``, as fresh clones."""
        with torch.cuda.device(self.device):
            self._copy_in(tensors)
            self.graph.replay()
            self.replays += 1
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
                "replays": self.replays, "launches": dict(self.launches)}


_graphs = LRU(MAX_GRAPHS, on_evict=Graph.release)
_seen = LRU(MAX_SEEN)
# captures since the last clear()
captures = 0


def run(fn, plan, *args):
    """``fn(*args, plan)``: the eager body off CUDA and on a key's first
    call; a captured graph's replay from the second call on (module
    docstring)."""
    global captures
    key, tensors = cache_key(fn, plan, *args)
    if key[2].type != "cuda":
        return fn(*args, plan)
    graph = _graphs.get(key)
    if graph is None:
        if key not in _seen:
            _seen.put(key, True)
            return fn(*args, plan)
        _seen.pop(key)
        _graphs.trim(MAX_GRAPHS - 1)  # evict before the capture allocates
        pool = next((g.graph.pool() for g in _graphs.values()
                     if g.device == key[2]), None)
        graph = Graph(fn, plan, key[2], key[3], tensors, pool)
        _graphs.put(key, graph)
        captures += 1
    return graph.replay(tensors)


def pool_bytes() -> int:
    """The bytes the cached graphs' pools hold on their devices."""
    pools = {(g.device.index, tuple(g.graph.pool())) for g in _graphs.values()}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if (seg["device"], tuple(seg["segment_pool_id"])) in pools)


def info() -> dict:
    """The captures since ``clear()``, the bytes of the graphs' pools, and
    each cached graph's ``info()``, least recently used first."""
    return {"captures": captures, "pool_bytes": pool_bytes(),
            "graphs": [g.info() for g in _graphs.values()]}


def clear() -> None:
    """Drop every graph and every once-seen key; the pools go back to the
    caching allocator (module docstring)."""
    global captures
    _graphs.clear()
    _seen.clear()
    captures = 0
