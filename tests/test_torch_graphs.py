"""The plan-keyed graph cache (``ops/graphs``) and the planned numeric
phases routed through it: chunked, grouped, tilepack and SpTRSV; the
solver path's structure-reuse product and triple product, aggregation
R·A·P, SpAdd and the ILU0 sweeps; bsr; tiled, fused, binned's per-bin
stage (K2 inside each) and the padded ESC.

On the CPU:

- the cache key: the row blocks of the out-of-core path share one key,
  another value dtype, capacity or plan gives another, every plan class
  hashes; a BSR and 0-d scalars go through the key and back; the LRU
  drops its least recent entries, by count or by their sizes, and hands
  them to the eviction hook; the cache's policy (capture stubbed): an
  AMG refresh's 9 keys beside 4 ESC keys capture once each, and a cycle
  over more keys than the byte budget holds captures each key once, not
  on every call; CPU tensors run the eager body and capture nothing;
- each eager body reads no value on the host: it runs to the end on fake
  tensors (``FakeTensorMode``), where ``.item()`` and ``nonzero`` raise,
  with the output shapes of the real run.

On the card (``cuda``-marked; they skip without one, and the card has no
jax, so run them there without the repository's conftest):

    python -m pytest tests/test_torch_graphs.py -m cuda --noconftest -q

- a replay is bit-equal to the eager body, and C matches scipy;
- two calls return distinct storage; new values on the same structure
  give the new product (an AMG refresh of A x 1.5 through every level);
- the out-of-core grouped blocks make one capture;
- the cached graphs share one pool, and replays of several graphs in any
  order each give their own eager result;
- replays add their captured K1 and K2 launches to the kernels'
  counters.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.models import amg as tamg
from benchmark_spgemm_using_csr_tpu_torch.models import ilu0 as tilu0
from benchmark_spgemm_using_csr_tpu_torch.ops import aggrap as tagg
from benchmark_spgemm_using_csr_tpu_torch.ops import batched as tb
from benchmark_spgemm_using_csr_tpu_torch.ops import binned as tbin
from benchmark_spgemm_using_csr_tpu_torch.ops import bsr as tbsr
from benchmark_spgemm_using_csr_tpu_torch.ops import chunked as tc
from benchmark_spgemm_using_csr_tpu_torch.ops import esc as tesc
from benchmark_spgemm_using_csr_tpu_torch.ops import fused as tfused
from benchmark_spgemm_using_csr_tpu_torch.ops import graphs
from benchmark_spgemm_using_csr_tpu_torch.ops import grouped as tg
from benchmark_spgemm_using_csr_tpu_torch.ops import kernels
from benchmark_spgemm_using_csr_tpu_torch.ops import reuse as tr
from benchmark_spgemm_using_csr_tpu_torch.ops import spadd as tsa
from benchmark_spgemm_using_csr_tpu_torch.ops import sptrsv as ts
from benchmark_spgemm_using_csr_tpu_torch.ops import tiled as tti
from benchmark_spgemm_using_csr_tpu_torch.ops import tilepack as tt
from benchmark_spgemm_using_csr_tpu_torch.ops.symbolic import total_products
from benchmark_spgemm_using_csr_tpu_torch.utils import generators as tgen
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-5)


def power_law(device="cpu", dtype=None, seed=1, m=400):
    mat = tgen.power_law(m, m, alpha=1.9, max_deg=40, seed=seed)
    return T.CSR.from_scipy(mat, dtype=dtype, device=device)


def triangular_system(device="cpu", m=300, seed=2):
    """A diagonally dominant matrix with both triangles, and a
    right-hand side."""
    rng = np.random.default_rng(seed)
    off = sp.random(m, m, density=0.02, random_state=seed, format="csr",
                    dtype=np.float32)
    mat = (off + sp.diags(np.full(m, 4.0, np.float32))).tocsr()
    return (T.CSR.from_scipy(mat, device=device),
            torch.from_numpy(rng.standard_normal(m).astype(np.float32))
            .to(device))


def block_csr(plan, a, i):
    """Row block ``i`` of the out-of-core plan, as ``spgemm_batched``
    builds it."""
    vals_pad = torch.cat([a.vals, a.vals.new_zeros(plan.nnz_cap)])
    s0 = plan.slice0[i]
    return T.CSR(plan.blk_rowptr[i], plan.blk_colidx[i],
                 vals_pad[s0: s0 + plan.nnz_cap], (plan.rows_cap, a.n))


def grouped_args(a, b, s):
    return (a, b, s.slot0, s.first_rank, s.sorted_off, s.fill_end)


def rap_operands(device="cpu", k=16, scale=1.0):
    """(R, A, P) of one aggregation level on a k x k Poisson grid, A's
    values times ``scale``."""
    a_sp = tgen.poisson2d(k)
    p_sp = tamg.aggregation_prolongator(a_sp).astype(np.float32).tocsr()
    a_sp = (a_sp * np.float32(scale)).astype(np.float32)
    return tuple(T.CSR.from_scipy(x, device=device)
                 for x in (p_sp.T.tocsr(), a_sp, p_sp))


def bsr_operands(device="cpu", m=256, block=(8, 128)):
    """(A, B, plan) of bsr on a banded matrix with its diagonal blocks."""
    s = tgen.banded(m, 24)
    a = T.BSR.from_scipy(s, block_shape=block, device=device)
    b = T.BSR.from_scipy(s, block_shape=(block[1], block[1]), device=device)
    return a, b, tbsr.make_bsr_plan(a, b)


def bin_args(a, b, width):
    """(rows, nnz_ct, prodstart) of binned's bin of ``width``, as
    ``spgemm_binned_host`` builds them."""
    from benchmark_spgemm_using_csr_tpu_torch.ops.symbolic import (
        nnz_upper_bound,
    )

    nnz_ct = nnz_upper_bound(a, b).long()
    bins, _ = tbin.make_plan(nnz_ct.cpu().numpy())
    rows = torch.from_numpy(bins[width]).to(a.device).long()
    return rows, nnz_ct, torch.cumsum(nnz_ct, 0) - nnz_ct


def ilu0_args(a):
    """The sweeps' tensor arguments on ``a``'s device, as ``ilu0`` uploads
    them."""
    a_sp = a.to_scipy()
    p = tilu0.ilu0_plan(a_sp)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(a.device)

    return (up(a_sp.data), up(p.dep_l), up(p.dep_u), up(p.dep_mask),
            up(p.diag_pos), up(p.is_lower), up(p.col_of.astype(np.int64)))


# ---- the cache key ---------------------------------------------------------


@pytest.mark.parametrize("method", ["grouped", "chunked"])
def test_batched_blocks_share_one_key(method):
    a = power_law()
    plan = tb.make_batched_plan(a, a, stream_budget=2000, method=method)
    assert len(plan.blocks) >= 3 and plan.method == method
    keys = set()
    for i in range(len(plan.blocks)):
        blk = block_csr(plan, a, i)
        if method == "grouped":
            s = plan.grouped_scheds[i]
            key, tensors = graphs.cache_key(tg._spgemm_grouped, s.plan,
                                            *grouped_args(blk, a, s))
            assert len(tensors) == 10
        else:
            key, tensors = graphs.cache_key(tc._spgemm_chunked,
                                            plan.chunked_plan, blk, a)
            assert len(tensors) == 6
        keys.add(key)
    assert len(keys) == 1


def chunked_key(a, b, plan):
    return graphs.cache_key(tc._spgemm_chunked, plan, a, b)[0]


@pytest.mark.parametrize("change", ["dtype", "capacity", "plan", "shape",
                                    "function"])
def test_key_changes(change):
    a = power_law()
    plan = tc.make_chunked_plan(a, a)
    base = chunked_key(a, a, plan)
    assert chunked_key(power_law(), power_law(), plan) == base
    if change == "dtype":
        b = power_law(dtype=torch.float64)
        other = chunked_key(b, b, plan)
    elif change == "capacity":
        b = a.with_capacity(a.capacity * 2)
        other = chunked_key(b, a, plan)
    elif change == "plan":
        other = chunked_key(a, a, dataclasses.replace(
            plan, chunks_cap=plan.chunks_cap * 2))
    elif change == "shape":  # the same buffers, another declared shape
        b = T.CSR(a.rowptr, a.colidx, a.vals, (a.m, a.n + 1))
        other = chunked_key(a, b, plan)
    else:
        other = graphs.cache_key(tg._spgemm_grouped, plan, a, a)[0]
    assert other != base


def test_key_rejects_mixed_devices_and_unknown_arguments():
    a = power_law()
    meta = T.CSR(a.rowptr.to("meta"), a.colidx.to("meta"), a.vals.to("meta"),
                 a.shape)
    with pytest.raises(ValueError, match="several devices"):
        graphs.cache_key(tc._spgemm_chunked, None, a, meta)
    with pytest.raises(TypeError, match="no graph argument"):
        graphs.cache_key(tc._spgemm_chunked, None, a, np.zeros(3))


def _plans():
    a = power_law()
    sys_a, _ = triangular_system()
    r, ap, p = rap_operands()
    ba, bb, bplan = bsr_operands()
    stencil = T.CSR.from_scipy(tgen.poisson2d(16), device="cpu")
    return {
        "ChunkedPlan": tc.make_chunked_plan(a, a),
        "GroupedPlan": tg.make_grouped_plan(a, a).plan,
        "TilePackPlan": tt.make_tilepack_plan(a, a).plan,
        "TrsvPlan": ts.make_trsv_plan(sys_a).plan,
        "NumericPlan": tr.make_numeric_plan(a, a).plan,
        "TriplePlan": tr.make_triple_plan(r, ap, p).plan,
        "AggRapPlan": tagg.make_aggrap_plan(r, ap, p).plan,
        "AddPlan": tsa.make_add_plan(a, a),
        "BsrPlan": bplan,
        "TiledPlan": tti.make_tiled_plan(stencil, stencil),
        "SpGemmPlan": tfused.make_plan(a, a),
        "EscPlan": tesc.EscPlan(1024, 512),
        "BinPlan": tbin.BinPlan(32),
        "SweepPlan": tilu0.SweepPlan(10),
    }


PLANS = ["ChunkedPlan", "GroupedPlan", "TilePackPlan", "TrsvPlan",
         "NumericPlan", "TriplePlan", "AggRapPlan", "AddPlan", "BsrPlan",
         "TiledPlan", "SpGemmPlan", "EscPlan", "BinPlan", "SweepPlan"]


@pytest.mark.parametrize("name", PLANS)
def test_plans_are_frozen_and_hash_by_value(name):
    plan = _plans()[name]
    assert type(plan).__name__ == name
    assert type(plan).__dataclass_params__.frozen
    for f in dataclasses.fields(plan):
        hash(getattr(plan, f.name))
    twin = dataclasses.replace(plan)
    assert twin is not plan and twin == plan and hash(twin) == hash(plan)


def test_describe_and_rebuild_round_trip():
    a = power_law()
    x = torch.arange(3)
    args = (a, (x,), x)
    leaves = []
    desc = graphs._describe(args, leaves)
    hash(desc)
    assert len(leaves) == 5
    back = graphs._rebuild(desc, iter(leaves))
    assert back[0].shape == a.shape and back[0].vals is a.vals
    assert back[1][0] is x and back[2] is x


@pytest.mark.parametrize("arg", ["bsr", "scalars"])
def test_describe_and_rebuild_bsr_and_scalars(arg):
    """A BSR goes through the key as its three buffers and its shape;
    spadd's 0-d scalars as tensors, whose values are not in the key."""
    if arg == "bsr":
        a, b, _ = bsr_operands()
        args = (a, b)
        n_leaves = 6
    else:
        a = power_law()
        args = (a, a, torch.full((), 0.5), torch.full((), -2.0))
        n_leaves = 8
    leaves = []
    desc = graphs._describe(args, leaves)
    hash(desc)
    assert len(leaves) == n_leaves
    back = graphs._rebuild(desc, iter(leaves))
    for x, y in zip(back, args):
        assert type(x) is type(y)
        if isinstance(y, T.BSR):
            assert x.shape == y.shape and x.blocks is y.blocks
            assert x.rowptr is y.rowptr and x.colidx is y.colidx
    if arg == "scalars":
        assert back[2] is args[2] and back[3] is args[3]
        other = (a, a, torch.full((), 3.0), torch.full((), 4.0))
        assert graphs._describe(other, []) == desc
        plan = tsa.make_add_plan(a, a)
        assert (graphs.cache_key(tsa._spadd, plan, *args)[0]
                == graphs.cache_key(tsa._spadd, plan, *other)[0])


# ---- the LRU ---------------------------------------------------------------


def test_lru_evicts_least_recent():
    gone = []
    lru = graphs.LRU(2, on_evict=gone.append)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1  # "b" is now the least recent
    lru.put("c", 3)
    assert gone == [2] and "b" not in lru and lru.get("b") is None
    assert "a" in lru and "c" in lru and len(lru) == 2
    lru.put("a", 4)  # a new value under a key: the old one leaves
    assert gone == [2, 1] and lru.get("a") == 4
    lru.pop("c")
    assert gone == [2, 1, 3] and len(lru) == 1
    lru.put("d", 5)
    lru.trim(0)
    assert gone == [2, 1, 3, 4, 5] and len(lru) == 0
    lru.clear()
    assert len(lru) == 0


def test_lru_by_size():
    gone = []
    lru = graphs.LRU(10, on_evict=gone.append, size=lambda v: v)
    lru.put("a", 4)
    lru.put("b", 5)
    assert lru.total == 9 and gone == []
    lru.put("c", 3)  # 12 > 10: "a" leaves
    assert gone == [4] and lru.total == 8 and "a" not in lru
    lru.put("d", 20)  # larger than the cap: it stays alone
    assert gone == [4, 5, 3] and lru.total == 20 and len(lru) == 1
    lru.clear()
    assert lru.total == 0 and gone == [4, 5, 3, 20]


def test_graph_cache_size_is_small():
    """The cache is bounded by its graphs' own bytes (static inputs and
    outputs), a small share of the card's memory."""
    assert graphs._graphs.cap == graphs.MAX_GRAPH_BYTES
    assert 256 << 20 <= graphs.MAX_GRAPH_BYTES <= 8 << 30
    assert graphs._graphs.size(type("G", (), {"nbytes": 123})()) == 123


class FakeGraph:
    """A stand-in for ``graphs.Graph``: its bytes, and whether it was
    released."""

    def __init__(self, key, nbytes):
        self.key, self.nbytes = key, nbytes
        self.device = key[2]
        self.pool = (0, 1)
        self.released = False

    def release(self):
        self.released = True


def cycle(keys, rounds, nbytes):
    """Call every key of ``keys`` in turn ``rounds`` times through the
    cache's lookup, capture stubbed; returns (captures, eager calls)."""
    graphs.clear()
    made, eager = [], 0
    for _ in range(rounds):
        for key in keys:
            g = graphs._lookup(key, lambda pool, key=key: made.append(
                FakeGraph(key, nbytes)) or made[-1])
            eager += g is None
    assert graphs.captures == len(made)
    return made, eager


def fake_key(i):
    return ("fn", i, torch.device("cuda", 0), ("tuple",))


def test_cache_holds_a_refresh_beside_the_esc_graphs():
    """9 coarse levels of one refresh and 4 ESC keys, called in a cycle:
    13 captures, then every call replays."""
    keys = [fake_key(i) for i in range(13)]
    made, eager = cycle(keys, 6, 64 << 20)
    assert len(made) == 13 and eager == 13  # each key's first call
    assert not any(g.released for g in made)
    assert len(graphs._graphs) == 13 and len(graphs._retired) == 0
    graphs.clear()
    assert all(g.released for g in made) and graphs.captures == 0


def test_cache_cycle_past_the_budget_captures_each_key_once():
    """A cycle over more keys than the budget holds: an evicted key runs
    eager from then on, and nothing captures again."""
    fit = 4
    keys = [fake_key(i) for i in range(fit + 3)]
    made, eager = cycle(keys, 8, graphs.MAX_GRAPH_BYTES // fit)
    assert len(made) == len(keys)  # once each, not once per call
    assert len(graphs._graphs) == fit
    assert sum(g.released for g in made) == len(keys) - fit
    assert len(graphs._retired) == len(keys) - fit
    calls = 8 * len(keys)
    assert eager == len(keys) + (len(keys) - fit) * 6  # retired: eager
    assert calls - eager - len(made) > 0  # the ones that stay replay
    graphs.clear()
    assert len(graphs._retired) == 0


def test_cpu_runs_the_eager_body_and_captures_nothing():
    graphs.clear()
    a = power_law()
    plan = tc.make_chunked_plan(a, a)
    calls = []

    def body(a, b, plan):
        calls.append(plan)
        return tc._spgemm_chunked(a, b, plan)

    outs = [graphs.run(body, plan, a, a) for _ in range(3)]
    assert len(calls) == 3
    assert graphs.info() == {"captures": 0, "retired": 0, "pool_bytes": 0,
                             "graph_bytes": 0, "graphs": []}
    assert len(graphs._seen) == 0
    want = tc._spgemm_chunked(a, a, plan)
    for c in outs:
        assert torch.equal(c.rowptr, want.rowptr)
        assert torch.equal(c.vals, want.vals)


# ---- the eager bodies read no value on the host ----------------------------


def bodies():
    """(name, body, plan, args, real output) of each planned phase."""
    from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: F401

    a = power_law()
    out = []
    for label, kw in [("narrow", dict(k=4, al=0)), ("aligned", dict(al=8)),
                      ("wide", dict(wide_min=16)),
                      ("mixed", dict(al=8, al_min=4))]:
        plan = tc.make_chunked_plan(a, a, **kw)
        out.append((f"chunked-{label}", tc._spgemm_chunked, plan, (a, a)))
    for al in (0, 4):
        s = tg.make_grouped_plan(a, a, al=al)
        out.append((f"grouped-al{al}", tg._spgemm_grouped, s.plan,
                    grouped_args(a, a, s)))
    s = tt.make_tilepack_plan(a, a)
    out.append(("tilepack", tt._spgemm_tilepack, s.plan,
                (a, a, s.slot0, s.q, s.first_rank)))
    sys_a, rhs = triangular_system()
    for label, kw, b in [("lower-unit", dict(lower=True, unit_diag=True), rhs),
                         ("upper", dict(lower=False), rhs),
                         ("lower-2rhs", dict(lower=True),
                          torch.stack([rhs, 2 * rhs], 1))]:
        s = ts.make_trsv_plan(sys_a, **kw)
        out.append((f"sptrsv-{label}", ts._solve, s.plan,
                    (sys_a, b, s.stream, s.diag_pos)))
    ns = tr.make_numeric_plan(a, a)
    out.append(("reuse-numeric", tr._numeric, ns.plan,
                (a.vals, a.vals, ns.a_idx, ns.b_idx, ns.lengths)))
    r, ap, p = rap_operands()
    trs = tr.make_triple_plan(r, ap, p)
    out.append(("reuse-triple", tr._triple_numeric, trs.plan,
                (r.vals, ap.vals, p.vals, trs.idx3, trs.lengths)))
    ags = tagg.make_aggrap_plan(r, ap, p)
    out.append(("aggrap", tagg._rap_aggregation, ags.plan,
                (ap.vals, ags.keys, ags.scale)))
    at = T.csr_transpose(a)
    out.append(("spadd", tsa._spadd, tsa.make_add_plan(a, at),
                (a, at, torch.full((), 0.5), torch.full((), -2.0))))
    ba, bb, bplan = bsr_operands(block=(16, 16))
    out.append(("bsr", tbsr._bsr_spgemm, bplan, (ba, bb)))
    stencil = T.CSR.from_scipy(tgen.poisson2d(16), device="cpu")
    out.append(("tiled", tti._spgemm_tiled,
                tti.make_tiled_plan(stencil, stencil), (stencil, stencil)))
    fplan = tfused.make_plan(a, a, widths=(8, 32))
    assert fplan.tail_rows  # the tail's ESC runs too
    out.append(("fused", tfused._spgemm_fused, fplan, (a, a)))
    for w in (8, 128):
        out.append((f"binned-w{w}", tbin._bin_numeric, tbin.BinPlan(w),
                    (a, a, *bin_args(a, a, w))))
    cap = 1 << 16
    out.append(("esc", tesc._spgemm_esc, tesc.EscPlan(cap, cap), (a, a)))
    out.append(("ilu0-sweeps", tilu0._sweep, tilu0.SweepPlan(3),
                ilu0_args(stencil)))
    return out


BODIES = [b[0] for b in bodies()]


@pytest.mark.parametrize("name", BODIES)
def test_body_reads_no_value_on_host(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, body, plan, args = next(b for b in bodies() if b[0] == name)
    real = body(*args, plan)
    real_leaves, fake_leaves = [], []
    desc = graphs._describe(real, real_leaves)
    mode = FakeTensorMode()
    in_leaves = []
    in_desc = graphs._describe(args, in_leaves)
    fake_args = graphs._rebuild(
        in_desc, iter([mode.from_tensor(t) for t in in_leaves]))
    with mode:
        fake = body(*fake_args, plan)
    assert graphs._describe(fake, fake_leaves) == desc
    for r, f in zip(real_leaves, fake_leaves):
        assert f.shape == r.shape and f.dtype == r.dtype


@pytest.mark.parametrize("read", ["item", "nonzero", "numpy"])
def test_fake_mode_catches_host_reads(read):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    x = mode.from_tensor(torch.arange(5.0))
    with mode, pytest.raises(Exception):
        if read == "item":
            (x.sum() > 0).item()
        elif read == "nonzero":
            torch.nonzero(x > 1)
        else:
            x.numpy()


# ---- on the card -----------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def bits(t):
    """A tensor's bytes, so values compare bit for bit."""
    return t.contiguous().view(torch.uint8)


def assert_bit_equal(x, y):
    if isinstance(x, T.CSR):
        for f in ("rowptr", "colidx", "vals"):
            assert torch.equal(bits(getattr(x, f)), bits(getattr(y, f))), f
    else:
        assert torch.equal(bits(x), bits(y))


def card_paths():
    """(name, public call, eager body call, check) on the card."""
    a = power_law("cuda", seed=3, m=2000)
    want = spgemm_reference(a, a)
    check = lambda c: assert_csr_equal(c, want, **F32_TOL)  # noqa: E731
    cp = tc.make_chunked_plan(a, a)
    gs = tg.make_grouped_plan(a, a)
    tps = tt.make_tilepack_plan(a, a)
    sys_a, rhs = triangular_system("cuda", m=2000)
    trs = ts.make_trsv_plan(sys_a)
    low = sp.tril(sys_a.to_scipy()).tocsr()

    def check_x(x):
        np.testing.assert_allclose(low @ x.cpu().numpy(), rhs.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)

    return {
        "chunked": (lambda: T.spgemm_chunked(a, a, cp),
                    lambda: tc._spgemm_chunked(a, a, cp), check),
        "grouped": (lambda: T.spgemm_grouped(a, a, gs),
                    lambda: tg._spgemm_grouped(*grouped_args(a, a, gs),
                                               gs.plan), check),
        "tilepack": (lambda: T.spgemm_tilepack(a, a, tps),
                     lambda: tt._spgemm_tilepack(a, a, tps.slot0, tps.q,
                                                 tps.first_rank, tps.plan),
                     check),
        "sptrsv": (lambda: T.sptrsv_planned(sys_a, rhs, trs),
                   lambda: ts._solve(sys_a, rhs, trs.stream, trs.diag_pos,
                                     trs.plan), check_x),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chunked", "grouped", "tilepack", "sptrsv"])
def test_replay_bit_equal_to_eager(path):
    need_card()
    graphs.clear()
    public, eager, check = card_paths()[path]
    first = public()  # eager
    assert graphs.info()["captures"] == 0
    second = public()  # capture + replay
    third = public()  # replay
    assert graphs.info()["captures"] == 1
    assert graphs.info()["graphs"][0]["replays"] == 2
    want = eager()
    for got in (first, second, third):
        assert_bit_equal(got, want)
        check(got)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chunked", "grouped", "tilepack", "sptrsv"])
def test_replay_outputs_are_distinct(path):
    need_card()
    graphs.clear()
    public, _, _ = card_paths()[path]
    outs = [public() for _ in range(4)]
    ptrs = [t.data_ptr() for o in outs
            for t in ((o.rowptr, o.colidx, o.vals) if isinstance(o, T.CSR)
                      else (o,))]
    assert len(set(ptrs)) == len(ptrs)
    keep = outs[2].vals.clone() if isinstance(outs[2], T.CSR) else \
        outs[2].clone()
    public()
    assert_bit_equal(outs[2].vals if isinstance(outs[2], T.CSR) else outs[2],
                     keep)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chunked", "grouped", "tilepack"])
def test_replay_new_values_same_structure(path):
    need_card()
    graphs.clear()
    a = power_law("cuda", seed=4, m=2000)
    make = {"chunked": tc.make_chunked_plan, "grouped": tg.make_grouped_plan,
            "tilepack": tt.make_tilepack_plan}[path]
    run = {"chunked": T.spgemm_chunked, "grouped": T.spgemm_grouped,
           "tilepack": T.spgemm_tilepack}[path]
    s = make(a, a)
    run(a, a, s)
    run(a, a, s)
    assert graphs.info()["captures"] == 1
    rng = np.random.default_rng(5)
    for _ in range(2):
        v = torch.from_numpy(rng.uniform(-1, 1, a.capacity)
                             .astype(np.float32)).cuda()
        b = T.CSR(a.rowptr, a.colidx, torch.where(
            torch.arange(a.capacity, device="cuda") < a.rowptr[-1], v, 0),
            a.shape)
        assert_csr_equal(run(b, b, s), spgemm_reference(b, b), **F32_TOL)
    assert graphs.info()["captures"] == 1


@pytest.mark.cuda
def test_replay_sees_in_place_writes():
    """An argument written in place since the last call is copied in
    again, though it is the very tensor copied in last time."""
    need_card()
    graphs.clear()
    a = power_law("cuda", seed=8, m=2000)
    a = T.CSR(a.rowptr, a.colidx, a.vals.clone(), a.shape)
    s = tg.make_grouped_plan(a, a)
    for _ in range(3):
        T.spgemm_grouped(a, a, s)
    a.vals.mul_(-2.0)
    assert_csr_equal(T.spgemm_grouped(a, a, s), spgemm_reference(a, a),
                     **F32_TOL)
    assert graphs.info()["captures"] == 1


@pytest.mark.cuda
def test_graphs_share_one_pool_and_interleave():
    """One graph's temporaries may lie on another's outputs in the shared
    pool: replays in an order unlike the captures' still each give their
    own eager result."""
    need_card()
    graphs.clear()
    paths = card_paths()
    names = ["chunked", "grouped", "tilepack", "sptrsv"]
    want = {n: paths[n][1]() for n in names}
    for n in names:  # eager, then capture
        paths[n][0]()
        paths[n][0]()
    info = graphs.info()
    assert info["captures"] == len(names)
    assert len({g.graph.pool() for g in graphs._graphs.values()}) == 1
    assert info["pool_bytes"] > 0
    for n in names[::-1] + names[1::2] + names[::2]:
        got = paths[n][0]()
        assert_bit_equal(got, want[n])
        paths[n][2](got)
    graphs.clear()
    assert graphs.info()["pool_bytes"] == 0


@pytest.mark.cuda
def test_batched_grouped_blocks_make_one_capture():
    need_card()
    graphs.clear()
    a = power_law("cuda", seed=6, m=3000)
    budget = -(-int(total_products(a, a)) // 3)
    plan = tb.make_batched_plan(a, a, stream_budget=budget, method="grouped")
    assert plan.method == "grouped" and len(plan.blocks) >= 3
    c = tb.spgemm_batched(a, a, stream_budget=budget, method="grouped")
    assert graphs.info()["captures"] == 1
    assert_csr_equal(c, spgemm_reference(a, a), **F32_TOL)


@pytest.mark.cuda
def test_replay_counts_k1_launches():
    need_card()
    graphs.clear()
    a = power_law("cuda", seed=7, m=2000)
    s = tt.make_tilepack_plan(a, a)
    kernels.tile_sort_merge.launches = 0
    T.spgemm_tilepack(a, a, s)  # eager: one launch
    assert kernels.tile_sort_merge.launches == 1
    T.spgemm_tilepack(a, a, s)  # warm-up launch + the first replay
    assert graphs.info()["graphs"][0]["launches"]["tile_sort_merge"] == 1
    assert kernels.tile_sort_merge.launches == 3
    for _ in range(3):
        T.spgemm_tilepack(a, a, s)
    assert kernels.tile_sort_merge.launches == 6


def scipy_check(want, tol=F32_TOL):
    """A check of a CSR or BSR result against the scipy matrix ``want``."""
    def check(c):
        got = c.to_scipy().tocsr() if isinstance(c, T.BSR) else c
        assert_csr_equal(got, want, **tol)
    return check


def new_card_paths(dev="cuda"):
    """(name, public call, eager call, check, graphs it captures) of this
    slice's paths on the card; the eager call runs the bodies with the
    graphs bypassed."""
    a = power_law(dev, seed=3, m=2000)
    want = spgemm_reference(a, a)
    r, ap, p = rap_operands(dev, k=48)
    rap = (r.to_scipy() @ ap.to_scipy() @ p.to_scipy()).tocsr()
    ns = tr.make_numeric_plan(a, a)
    trs = tr.make_triple_plan(r, ap, p)
    ags = tagg.make_aggrap_plan(r, ap, p)
    at = T.csr_transpose(a)
    aplan = tsa.make_add_plan(a, at)
    add = (0.5 * a.to_scipy() - 2.0 * at.to_scipy()).tocsr()
    ba, bb, bplan = bsr_operands(dev, m=1024)
    bwant = (ba.to_scipy() @ bb.to_scipy()).tocsr()
    st = T.CSR.from_scipy(tgen.poisson2d(64), device=dev)
    tplan = tti.make_tiled_plan(st, st)
    fplan = tfused.make_plan(a, a)
    cap = int(total_products(a, a))
    f_cpu = tilu0.ilu0(T.CSR.from_scipy(st.to_scipy(), device="cpu"),
                       sweeps=5)

    def ilu0_check(f):
        np.testing.assert_allclose(f.to_scipy().toarray(),
                                   f_cpu.to_scipy().toarray(), rtol=1e-5,
                                   atol=1e-6)

    calls = {
        "numeric": (lambda: T.spgemm_numeric(a, a, ns), scipy_check(want),
                    1),
        "triple": (lambda: tr.spgemm_triple(r, ap, p, trs),
                   scipy_check(rap, RAP_TOL), 1),
        "aggrap": (lambda: tagg.rap_aggregation(ap, ags),
                   scipy_check(rap, RAP_TOL), 1),
        "spadd": (lambda: tsa.spadd_planned(a, at, aplan, 0.5, -2.0),
                  scipy_check(add), 1),
        "bsr": (lambda: tbsr.bsr_spgemm(ba, bb, bplan), scipy_check(bwant),
                1),
        "tiled": (lambda: tti.spgemm_tiled(st, st, tplan),
                  scipy_check(spgemm_reference(st, st)), 1),
        "fused": (lambda: tfused.spgemm_fused(a, a, fplan),
                  scipy_check(want), 1),
        "binned": (lambda: tbin.spgemm_binned_host(a, a, cap),
                   scipy_check(want),
                   sum(x > 0 for x in fplan.bin_rows)
                   + (fplan.tail_rows > 0)),
        "esc": (lambda: tesc.spgemm_esc_padded(a, a, cap, cap),
                scipy_check(want), 1),
        "ilu0": (lambda: tilu0.ilu0(st, sweeps=5), ilu0_check, 1),
    }

    def eager(fn):
        def run():
            with graphs.eager():
                return fn()
        return run

    return {k: (pub, eager(pub), check, n)
            for k, (pub, check, n) in calls.items()}


RAP_TOL = dict(rtol=1e-3, atol=1e-4)
NEW_PATHS = ["numeric", "triple", "aggrap", "spadd", "bsr", "tiled", "fused",
             "binned", "esc", "ilu0"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", NEW_PATHS)
def test_new_path_replay_bit_equal_to_eager(path):
    """The first call runs eager, the second captures (one graph a planned
    body: binned's bins and its tail's ESC each have one), later calls
    replay; every result is bit-equal to the eager bodies' and verified
    against scipy."""
    need_card()
    graphs.clear()
    public, eager, check, n_graphs = new_card_paths()[path]
    first = public()
    assert graphs.info()["captures"] == 0
    second = public()
    third = public()
    assert graphs.info()["captures"] == n_graphs
    assert all(g["replays"] == 2 for g in graphs.info()["graphs"])
    want = eager()
    assert graphs.info()["captures"] == n_graphs
    for got in (first, second, third):
        if isinstance(got, T.BSR):
            for f in ("rowptr", "colidx", "blocks"):
                assert torch.equal(bits(getattr(got, f)),
                                   bits(getattr(want, f))), f
        else:
            assert_bit_equal(got, want)
        check(got)


@pytest.mark.cuda
def test_refresh_replays_every_level_with_new_values():
    """An unsmoothed hierarchy's numeric refresh captures one graph a
    coarse level and no more; A x 1.5 replays them and every level holds
    against scipy's R·A·P."""
    need_card()
    graphs.clear()
    a_sp = tgen.poisson2d(64)
    h = tamg.build_hierarchy(a_sp, smooth=False, device="cuda")
    assert len(h.levels) >= 3
    graphs.clear()
    for scale in (1.0, 1.0, 1.5, 1.5, 2.0):
        a_new_sp = (a_sp * np.float32(scale)).astype(np.float32)
        h2 = tamg.numeric_refresh(h, T.CSR.from_scipy(a_new_sp,
                                                      device="cuda"))
        cur = a_new_sp.astype(np.float64)
        for li in range(1, len(h.levels)):
            rr = h.levels[li].r.to_scipy().astype(np.float64)
            pp = h.levels[li].p.to_scipy().astype(np.float64)
            cur = (rr @ cur @ pp).tocsr()
            assert_csr_equal(h2.levels[li].a, cur, **RAP_TOL)
    assert graphs.info()["captures"] == len(h.levels) - 1
    assert all(g["replays"] == 4 for g in graphs.info()["graphs"])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tiled", "fused"])
def test_replay_counts_k2_launches(path):
    need_card()
    graphs.clear()
    public, _, _, _ = new_card_paths()[path]
    kernels.bin_sort_compress.launches = 0
    public()  # eager
    per_call = kernels.bin_sort_compress.launches
    assert per_call >= 1
    public()  # warm-up + the first replay
    g = graphs.info()["graphs"][0]
    assert g["launches"]["bin_sort_compress"] == per_call
    assert kernels.bin_sort_compress.launches == 3 * per_call
    for _ in range(3):
        public()
    assert kernels.bin_sort_compress.launches == 6 * per_call
