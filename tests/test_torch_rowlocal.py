"""Kernel K6 (``ops/rowlocal.rowlocal_esc``, ``csrc/rowlocal_esc.cu``): C =
A·B one row of A at a time, the chunked plan's row-local route.

On the CPU ``rowlocal_esc`` runs its plain version, held here to scipy
(structure exact, values within the float32 tolerance; float64 at 1e-12;
bfloat16 rounded once from float32 sums) on the benchmark's three
generators at their CPU size, rectangular and empty operands, and rows at
K6's edges. The kernel's own arithmetic (each column's products ordered by
their value bits and summed with the addition tree, bucket by bucket) is
replayed in numpy and held bit for bit to the plain version, which sorts
and sums the whole stream. The launch's shared memory is the layout's, and
a row past K6's widest keeps the plan on the stream. The tests marked
``cuda`` hold K6 to its plain version, bit for bit, and a graph replay to
its eager call on the card; run them there without the repository's
conftest:

    python -m pytest tests/test_torch_rowlocal.py -m cuda --noconftest -q
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu_torch.ops import chunked, graphs, rowlocal
from benchmark_spgemm_using_csr_tpu_torch.ops.stream import pad_gentle
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR, pad_bucket
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _bench(name):
    """The benchmark generator's matrix at its CPU size, twice (A·A)."""
    gen = importlib.import_module(f"spgemm_bench.generators.{name}")
    rowptr, colidx, vals, shape = gen.generate(**gen.SMALL_PARAMS)
    a = sp.csr_matrix((vals, colidx, rowptr), shape=shape)
    return a, a


def _rect():
    rng = np.random.default_rng(7)
    a = sp.random(300, 200, density=0.04, random_state=rng, format="csr",
                  dtype=np.float32)
    b = sp.random(200, 250, density=0.05, random_state=rng, format="csr",
                  dtype=np.float32)
    return a, b


def _empty_rows():
    rng = np.random.default_rng(3)
    a = sp.random(200, 200, density=0.03, random_state=rng, format="lil",
                  dtype=np.float32)
    a[50:90, :] = 0
    b = a.copy()
    b[100:180, :] = 0
    return a.tocsr(), b.tocsr()


def _csr(rows, vals, ncols):
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    cols = np.concatenate([np.asarray(r, np.int64) for r in rows])
    return sp.csr_matrix((np.concatenate(vals).astype(np.float32),
                          cols.astype(np.int32), indptr),
                         shape=(len(rows), ncols))


# the widest row of _edges: products whose shared memory (with the row's
# 450 columns at most) two blocks of K6 an SM still hold; 600 more they do
# not
WIDEST = 6400


def _edges(widest=WIDEST):
    """Rows at K6's edges. B: rows 0..99 of 82 entries in columns 0..199
    (so a column repeats across them, up to the A row's length), rows
    100..2999 of one entry, rows 3000..3099 empty; values small integers
    and their negations, so sums cancel to +-0.0. A: a row of exactly
    ``widest`` products (up to 75 long B rows, the rest one-entry rows), a
    row of 700 entries (windows of A entries past a block's threads), a row
    whose entries name empty B rows only, an empty row, a row of one
    product, a row whose A values are -0.0 and +0.0, and short random
    rows."""
    rng = np.random.default_rng(23)
    n = 5000
    b_rows, b_vals = [], []
    for j in range(3100):
        if j < 100:
            cols = np.sort(rng.choice(200, size=82, replace=False))
        elif j < 3000:
            cols = rng.choice(n, size=1)
        else:
            cols = np.zeros(0, np.int64)
        b_rows.append(cols)
        half = rng.integers(1, 4, size=cols.size).astype(np.float32)
        b_vals.append(np.where(rng.random(cols.size) < 0.5, half, -half))
    ones = np.arange(100, 3000)
    longs = min(75, widest // 82)
    a_rows = [
        np.sort(np.concatenate([np.arange(longs), rng.choice(
            ones, size=widest - longs * 82, replace=False)])),
        np.sort(rng.choice(ones, size=700, replace=False)),
        np.arange(3000, 3005),
        np.zeros(0, np.int64),
        np.array([100]),
        np.array([3, 4, 500]),
    ]
    a_rows += [np.sort(rng.choice(3100, size=rng.integers(1, 30),
                                  replace=False)) for _ in range(40)]
    a_vals = [rng.integers(-2, 3, size=len(r)).astype(np.float32)
              for r in a_rows]
    a_vals[5] = np.array([-0.0, 0.0, -0.0], np.float32)
    return _csr(a_rows, a_vals, 3100), _csr(b_rows, b_vals, n)


PAIRS = {
    "circuit": lambda: _bench("circuit"),
    "poisson2d": lambda: _bench("poisson2d"),
    "fem_irregular": lambda: _bench("fem_irregular"),
    "rect": _rect,
    "empty_rows": _empty_rows,
    "edges": _edges,
    "edges_4000": lambda: _edges(4000),  # fits in float64 too
}
# the pairs whose chunked plan takes the route; circuit's hub row needs
# more shared memory than two blocks an SM hold, so its plan keeps the
# stream (K6 still runs it, one block an SM)
ROUTED = sorted(set(PAIRS) - {"circuit"})


def csrs(sa, sb, device="cpu", dtype=None):
    a = CSR.from_scipy(sa, device=device, dtype=dtype)
    b = a if sb is sa else CSR.from_scipy(sb, device=device, dtype=dtype)
    return a, b


def route_of(a, b):
    """The chunked plan of A·B, which must take the route."""
    plan = chunked.make_chunked_plan(a, b)
    assert plan.rowlocal is not None
    return plan


def launch_of(sa, sb, dtype=torch.float32):
    """(K6's launch, out_cap, max_run) for A·B, the route the plan would
    take, or with one block an SM where it keeps the stream."""
    sa, sb = sa.tocsr(), sb.tocsr()
    c_rows = np.diff((_pat(sa) @ _pat(sb)).indptr)
    route = rowlocal.make_launch(_products(sa, sb), c_rows, dtype)
    assert route is not None
    max_run = max(int(np.diff(sa.indptr).max(initial=1)), 1)
    return route, pad_gentle(max(int(c_rows.sum()), 1)), pad_bucket(max_run)


def bits(x: torch.Tensor) -> np.ndarray:
    """The values' bit patterns, as integers of their width."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return x.cpu().view(ints[x.element_size()]).numpy()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plain_version_is_scipys_product(name):
    """The structure is the pattern product's, every structural entry kept
    (a stored zero or a cancelling sum too); the values scipy's, both
    sides pruned of exact zeros (scipy drops them). Where the plan takes
    the route, its call is this one."""
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb)
    route, out_cap, max_run = launch_of(sa, sb)
    before = rowlocal.rowlocal_esc.launches
    c = rowlocal.rowlocal_esc(a, b, route, out_cap=out_cap, max_run=max_run)
    assert rowlocal.rowlocal_esc.launches == before  # the plain version
    assert np.array_equal(c.rowptr.numpy(), (_pat(sa) @ _pat(sb)).indptr)
    assert_csr_equal(c, spgemm_reference(a, b), check_explicit_zeros=False,
                     **F32_TOL)
    nnz = int(c.rowptr[-1])
    assert out_cap == pad_gentle(max(nnz, 1)) == c.capacity
    assert not c.colidx[nnz:].any() and not c.vals[nnz:].any()
    plan = chunked.make_chunked_plan(a, b)
    assert (plan.rowlocal is not None) == (name in ROUTED)
    if plan.rowlocal is not None:
        assert (plan.rowlocal, plan.out_cap, plan.max_run) == (
            route, out_cap, max_run)
        same = chunked.spgemm_chunked(a, b, plan)
        assert torch.equal(same.colidx, c.colidx)
        assert np.array_equal(bits(same.vals), bits(c.vals))


@pytest.mark.parametrize("name", ["edges_4000", "poisson2d", "rect"])
def test_float64_against_scipy(name):
    sa, sb = PAIRS[name]()
    a, b = csrs(sa.astype(np.float64), sb.astype(np.float64))
    plan = route_of(a, b)
    assert plan.rowlocal.smem == int(rowlocal.smem_bytes(
        _products(sa, sb), np.diff((_pat(sa) @ _pat(sb)).indptr),
        True).max())
    c = chunked.spgemm_chunked(a, b, plan)
    assert c.vals.dtype == torch.float64
    assert_csr_equal(c, spgemm_reference(a, b), check_explicit_zeros=False,
                     rtol=1e-12, atol=1e-12)


def test_bfloat16_sums_in_float32_and_rounds_once():
    sa, sb = _rect()
    a, b = csrs(sa, sb, dtype=torch.bfloat16)
    plan = route_of(a, b)
    c = chunked.spgemm_chunked(a, b, plan)
    assert c.vals.dtype == torch.bfloat16
    a32 = CSR(rowptr=a.rowptr, colidx=a.colidx, vals=a.vals.float(),
              shape=a.shape)
    b32 = CSR(rowptr=b.rowptr, colidx=b.colidx, vals=b.vals.float(),
              shape=b.shape)
    c32 = rowlocal.rowlocal_esc_plain(a32, b32, out_cap=plan.out_cap,
                                      max_run=plan.max_run)
    assert torch.equal(c.colidx, c32.colidx)
    assert torch.equal(c.vals, c32.vals.to(torch.bfloat16))


def _pat(x):
    x = x.tocsr()
    return sp.csr_matrix((np.ones(x.nnz, bool), x.indices, x.indptr),
                         shape=x.shape)


def _products(sa, sb):
    """Each row's product count."""
    blen = np.diff(sb.indptr)
    cum = np.concatenate([[0], np.cumsum(blen[sa.indices])])
    return cum[sa.indptr[1:]] - cum[sa.indptr[:-1]]


def _order(v: np.ndarray) -> np.ndarray:
    b = v.view(np.int32).astype(np.int64)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def tail_sum(x: np.ndarray, max_run: int) -> np.float32:
    """The addition tree's value at a run's last lane, as K6 computes it:
    the plain version's lane q after the passes k = 1, 2, ... < max_run
    (lane q adds lane q-k's partial where it lies in the run, else +0.0) is
    a pairwise reduction from the last lane back: at step k, partial m
    (lane L-1-m·k) adds partial m+1 of the step before, or +0.0 where that
    lane lies before the run; once k reaches L only +0.0 is added."""
    w = list(x[::-1])
    n, half = len(w), 1
    while half < max_run and half < len(x):
        nxt = (n + 1) // 2
        for m in range(nxt):
            right = w[2 * m + 1] if 2 * m + 1 < n else np.float32(0)
            w[m] = np.float32(w[2 * m] + right)
        n, half = nxt, half * 2
    if 1 << (len(x) - 1).bit_length() < max_run:
        return np.float32(w[0] + np.float32(0))
    return w[0]


def bucket_sums(sa, sb, max_run: int):
    """K6's arithmetic in numpy, float32: each row's products bucketed by
    column, a bucket's values ordered by their bits, then the tree's value
    at its last lane (``tail_sum``). Returns (indptr, columns, sums)."""
    indptr, cols, sums = [0], [], []
    for i in range(sa.shape[0]):
        buckets = {}
        for e in range(sa.indptr[i], sa.indptr[i + 1]):
            j, av = sa.indices[e], np.float32(sa.data[e])
            for f in range(sb.indptr[j], sb.indptr[j + 1]):
                buckets.setdefault(int(sb.indices[f]), []).append(
                    np.float32(av * np.float32(sb.data[f])))
        for col in sorted(buckets):
            x = np.array(buckets[col], np.float32)
            cols.append(col)
            sums.append(tail_sum(x[np.argsort(_order(x), kind="stable")],
                                 max_run))
        indptr.append(len(cols))
    return np.array(indptr), np.array(cols), np.array(sums, np.float32)


def test_the_tail_sum_is_the_passes_last_lane():
    """``tail_sum`` against the passes run lane by lane over one run, for
    runs of every length to 40 (-0.0 among the values) and bounds past and
    below the length."""
    rng = np.random.default_rng(5)
    for length in range(1, 41):
        x = rng.standard_normal(length).astype(np.float32)
        x[rng.random(length) < 0.2] = -0.0
        for max_run in (1, 2, 4, 16, 64, 128):
            run, k = x.copy(), 1
            while k < max_run:
                shifted = np.concatenate([np.zeros(min(k, length),
                                                   np.float32), run[:-k]])
                run = (run + shifted[:length]).astype(np.float32)
                k *= 2
            assert run[-1].view(np.int32) == tail_sum(x, max_run).view(
                np.int32), (length, max_run)


@pytest.mark.parametrize("name", ["edges", "poisson2d", "rect"])
def test_the_kernels_bucket_sums_are_the_plain_versions(name):
    """The kernel sorts and sums each column's products alone; the plain
    version sorts the whole stream by (row, column, value bits) and runs
    its passes over all of it. Both give the same bits, -0.0 and +0.0
    included."""
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb)
    plan = route_of(a, b)
    c = rowlocal.rowlocal_esc_plain(a, b, out_cap=plan.out_cap,
                                    max_run=plan.max_run)
    indptr, cols, sums = bucket_sums(sa.tocsr(), sb.tocsr(), plan.max_run)
    nnz = indptr[-1]
    assert np.array_equal(c.rowptr.numpy(), indptr)
    assert np.array_equal(c.colidx[:nnz].numpy(), cols)
    assert np.array_equal(bits(c.vals[:nnz]), sums.view(np.int32))
    if name == "edges":  # the edge rows reach +-0.0 sums
        assert (sums.view(np.int32) == np.int32(-2**31)).any() or (
            sums == 0).any()


def test_launch_layout_and_limits():
    """The shared memory of a row (csrc/rowlocal_esc.cu's layout), the
    thread count, and the rows K6 refuses."""
    # fem_81k's widest row: 6,426 products and 375 columns
    need = rowlocal.smem_bytes(np.array([6426]), np.array([375]), False)
    assert need[0] == 8 * 512 + 4 * (2 * 2048 + 376) + 6426 * 12
    # one product and column in float64: 8 + 4 * (2 * 32 + 2) = 272, then
    # 20 bytes a product
    assert rowlocal.smem_bytes(np.array([1]), np.array([1]),
                               True)[0] == 272 + 20
    route = rowlocal.make_launch(np.array([6426, 10]), np.array([375, 3]),
                                 torch.float32)
    assert route == rowlocal.RowLocal(smem=int(need[0]), threads=512,
                                      slots=6436)
    assert rowlocal.make_launch(np.array([rowlocal.MAX_PRODUCTS + 1]),
                                np.array([5]), torch.float32) is None
    assert rowlocal.make_launch(np.array([8000]), np.array([8000]),
                                torch.float32) is None  # shared memory
    assert rowlocal.make_launch(np.array([10]), np.array([3]),
                                torch.int32) is None
    assert rowlocal.make_launch(np.array([10]), np.array([3]),
                                torch.float32).threads == 64


@pytest.mark.parametrize("widest", [rowlocal.MAX_PRODUCTS + 1, WIDEST + 600],
                         ids=["products", "shared_memory"])
def test_a_row_past_the_widest_keeps_the_stream(widest):
    """A row of more products than K6 takes, or whose shared memory two
    blocks an SM cannot hold: the plan keeps the stream, and its C is the
    stream's."""
    sa, sb = _edges(widest)
    a, b = csrs(sa, sb)
    plan = chunked.make_chunked_plan(a, b)
    assert plan.rowlocal is None and plan.slots == plan.prod_cap
    assert plan == chunked.make_chunked_plan(a, b, rowlocal=False)
    c = chunked.spgemm_chunked(a, b, plan)
    assert np.array_equal(c.rowptr.numpy(), (_pat(sa) @ _pat(sb)).indptr)
    assert_csr_equal(c, spgemm_reference(a, b), check_explicit_zeros=False,
                     **F32_TOL)


def test_shard_and_block_plans_keep_the_stream():
    from benchmark_spgemm_using_csr_tpu_torch.ops import batched

    a, b = csrs(*_bench("fem_irregular"))
    assert chunked.make_chunked_plan(a, b).rowlocal is not None
    for n_shards in (1, 3):
        assert chunked.make_dist_local_plan(a, b, n_shards).rowlocal is None
    assert chunked.make_chunked_plan(a, b, al=16).rowlocal is None
    products = int(_products(*_bench("fem_irregular")).sum())
    plan = batched.make_batched_plan(a, b, stream_budget=products // 3,
                                     method="chunked")
    assert plan.method == "chunked" and plan.chunked_plan.rowlocal is None


def test_counters_on_the_route():
    from benchmark_spgemm_using_csr_tpu_torch.utils import profiling

    a, b = csrs(*_rect())
    plan = route_of(a, b)
    profiling.reset()
    with profiling.recording():
        chunked.spgemm_chunked(a, b, plan)
    counters = profiling.totals()["counters"]
    assert counters["chunked.rowlocal_rows"] == a.m
    assert counters["chunked.slots"] == plan.rowlocal.slots == int(
        _products(*_rect()).sum())
    assert counters["chunked.out_slots"] == plan.out_cap
    profiling.reset()


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _on_card(sa, sb, dtype=None):
    a, b = csrs(sa, sb, "cuda", dtype)
    route, out_cap, max_run = launch_of(sa, sb, a.vals.dtype)
    got = rowlocal.rowlocal_esc(a, b, route, out_cap=out_cap,
                                max_run=max_run)
    want = rowlocal.rowlocal_esc_plain(a, b, out_cap=out_cap,
                                       max_run=max_run)
    torch.cuda.synchronize()
    return got, want


def same_bits(got, want):
    assert torch.equal(got.rowptr, want.rowptr)
    assert torch.equal(got.colidx, want.colidx)
    assert np.array_equal(bits(got.vals), bits(want.vals))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_k6_equals_its_plain_version(name, need_card):
    before = rowlocal.rowlocal_esc.launches
    got, want = _on_card(*PAIRS[name]())
    assert rowlocal.rowlocal_esc.launches == before + 1
    same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k6_equals_its_plain_version_in(dtype, need_card):
    sa, sb = _edges(4000)
    if dtype == torch.float64:
        sa, sb = sa.astype(np.float64), sb.astype(np.float64)
        dtype = None
    got, want = _on_card(sa, sb, dtype)
    same_bits(got, want)


@pytest.mark.cuda
def test_a_replay_is_bit_equal_to_its_eager_call(need_card):
    """First call eager, the second captures, the third replays with new
    values: each bit-equal to the body run eager, K5 and K6 in the graph."""
    sa, _ = _bench("fem_irregular")
    a = CSR.from_scipy(sa, device="cuda")
    plan = route_of(a, a)
    graphs.clear()
    try:
        for scale in (1.0, 1.5, -0.75):
            x = CSR(rowptr=a.rowptr, colidx=a.colidx, vals=a.vals * scale,
                    shape=a.shape)
            got = chunked.spgemm_chunked(x, x, plan)
            with graphs.eager():
                want = chunked.spgemm_chunked(x, x, plan)
            torch.cuda.synchronize()
            same_bits(got, want)
        info = graphs.info()
        assert info["captures"] == 1
        assert info["graphs"][0]["launches"]["rowlocal_esc"] == 1
        assert info["graphs"][0]["launches"]["symbolic_count"] == 1
    finally:
        graphs.clear()
