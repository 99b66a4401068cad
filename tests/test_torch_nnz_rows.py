"""Kernel K5 (``ops/symbolic.nnz_rows``, ``csrc/symbolic_count.cu``): the
exact per-row structural nnz(C) of C = A·B, and the host plans that count
nnz(C) through ``ops/symbolic.exact_nnz_c``.

On the CPU ``nnz_rows`` runs its plain version ``nnz_exact``, held here to
scipy's per-row counts of the pattern product (every stored entry True), on
the benchmark's three generators at their CPU size, rectangular and empty
operands, and rows in each of K5's bins (at most 32 products, at most 1024,
more) and at their edges. The plans built with that count equal the plans
scipy's count builds, field for field; a stored zero pins the count to the
structure, which is the key set the numeric phases produce. The tests marked
``cuda`` hold K5 to its plain version and the plans it builds to the CPU's on
the card; run them there without the repository's conftest:

    python -m pytest tests/test_torch_nnz_rows.py -m cuda --noconftest -q
"""
import dataclasses
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu_torch.ops import grouped, symbolic, tilepack
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR

torch.set_num_threads(2)


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
    """Empty rows of A, and empty rows of B that A's entries name."""
    rng = np.random.default_rng(3)
    a = sp.random(200, 200, density=0.03, random_state=rng, format="lil",
                  dtype=np.float32)
    a[50:90, :] = 0
    b = a.copy()
    b[100:180, :] = 0
    return a.tocsr(), b.tocsr()


# product counts of _bins' rows: the edges of K5's bins (32: a warp's
# lanes; 1024: the medium hash), 0 with and without A entries, and long
# rows (each more products than the bitmap's words: cleared whole)
BIN_ROWS = (0, 1, 31, 32, 33, 500, 1023, 1024, 1025, 4000, 15000)


def _bins():
    """Rows of chosen product counts (BIN_ROWS, each twice: once over
    columns drawn from a narrow range, so products repeat, once from all
    of B's), a row of more than 32 A entries with at most 32 products,
    rows of more than 32 and 256 A entries (several windows of a warp and
    of a block), and an empty row. B: rows 0..999 of 32 entries, rows
    1000..2999 of one, rows 3000..3099 empty."""
    rng = np.random.default_rng(11)
    n = 3100
    b_rows = []
    for j in range(n):
        narrow = j % 2 == 0
        span = 160 if narrow else n
        length = 32 if j < 1000 else (1 if j < 3000 else 0)
        b_rows.append(np.sort(rng.choice(span, size=length, replace=False)))
    empty_b = np.arange(3000, 3100)

    def row_for(p, narrow):
        longs = rng.choice(np.arange(0 if narrow else 1, 1000, 2),
                           size=p // 32, replace=False)
        ones = rng.choice(np.arange(1000, 3000), size=p % 32, replace=False)
        return np.concatenate([longs, ones])

    a_rows = [row_for(p, narrow) for p in BIN_ROWS for narrow in (True, False)]
    a_rows.append(rng.choice(empty_b, size=5, replace=False))  # P = 0
    a_rows.append(np.array([], np.int64))  # empty
    a_rows.append(np.concatenate([  # 70 entries, 30 products
        rng.choice(empty_b, size=40, replace=False),
        rng.choice(np.arange(1000, 3000), size=30, replace=False)]))
    a_rows.append(np.concatenate([  # 40 entries, 999 products (medium)
        rng.choice(np.arange(0, 1000, 2), size=31, replace=False),
        rng.choice(np.arange(1000, 3000), size=7, replace=False),
        rng.choice(empty_b, size=2, replace=False)]))
    a_rows.append(np.concatenate([  # 700 entries: three block windows
        rng.choice(np.arange(0, 1000), size=300, replace=False),
        rng.choice(np.arange(1000, 3100), size=400, replace=False)]))

    def csr(rows, ncols):
        indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        cols = np.concatenate([np.sort(r) for r in rows]).astype(np.int32)
        vals = rng.standard_normal(cols.size).astype(np.float32)
        return sp.csr_matrix((vals, cols, indptr), shape=(len(rows), ncols))

    return csr(a_rows, n), csr(b_rows, n)


def _wide(n):
    """64 rows of about 1,440 products each into n columns, two of them the
    last: K5's long rows clear their bitmap by walking their products again
    (P < n / 32); past 1.8M columns the bitmaps lie in device memory."""
    rng = np.random.default_rng(5)
    b = sp.random(600, n, density=40 / n, random_state=rng, format="lil",
                  dtype=np.float32)
    b[7, n - 3] = 1.0
    b[7, n - 1] = 1.0
    a = sp.random(64, 600, density=0.06, random_state=rng, format="lil",
                  dtype=np.float32)
    a[0, 7] = 1.0
    return a.tocsr(), b.tocsr()


PAIRS = {
    "circuit": lambda: _bench("circuit"),
    "poisson2d": lambda: _bench("poisson2d"),
    "fem_irregular": lambda: _bench("fem_irregular"),
    "rect": _rect,
    "empty_rows": _empty_rows,
    "bins": _bins,
    "walk": lambda: _wide(70_000),
    "wide": lambda: _wide((1 << 21) + 5),
}
BENCH = ("circuit", "poisson2d", "fem_irregular")


def pattern_counts(sa, sb):
    """scipy's per-row nnz of the pattern product (stored entries True)."""
    def pat(x):
        x = x.tocsr()
        return sp.csr_matrix((np.ones(x.nnz, bool), x.indices, x.indptr),
                             shape=x.shape)

    return np.diff((pat(sa) @ pat(sb)).indptr)


def csrs(sa, sb, device="cpu"):
    a = CSR.from_scipy(sa, device=device)
    b = a if sb is sa else CSR.from_scipy(sb, device=device)
    return a, b


def test_bins_reach_every_bin():
    sa, sb = _bins()
    a, b = csrs(sa, sb)
    p = symbolic.nnz_upper_bound(a, b).numpy()
    assert list(p[: 2 * len(BIN_ROWS): 2]) == list(BIN_ROWS)
    assert (p <= 32).any() and ((p > 32) & (p <= 1024)).any()
    assert (p > 1024).any() and (p > 3100 // 32).any()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plain_version_is_scipys_pattern_count(name):
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb)
    got = symbolic.nnz_rows(a, b)
    assert got.dtype == torch.int32 and got.shape == (sa.shape[0],)
    np.testing.assert_array_equal(got.numpy(), pattern_counts(sa, sb))
    assert symbolic.exact_nnz_c(a, b) == int(pattern_counts(sa, sb).sum())


def test_nnz_rows_checks_its_operands():
    sa, sb = _rect()
    a, b = csrs(sa, sb)
    with pytest.raises(ValueError, match="inner dims"):
        symbolic.nnz_rows(b, b)
    assert symbolic.nnz_rows(a, b).shape == (300,)


def same_schedule(x, y):
    """Two schedules equal field for field: the plan's statics and every
    structure tensor (on the host)."""
    if x is None or y is None:
        return x is None and y is None
    for f in dataclasses.fields(x):
        u, v = getattr(x, f.name), getattr(y, f.name)
        if isinstance(u, torch.Tensor):
            if not (u.dtype == v.dtype and torch.equal(u.cpu(), v.cpu())):
                return False
        elif u != v:
            return False
    return True


def _counted(a, b):
    """nnz(C) as the plans take it on the card: K5's rows, summed (here
    its plain version)."""
    return int(symbolic.nnz_rows(a, b).sum())


@pytest.mark.parametrize("name", BENCH + ("rect", "bins"))
def test_plans_built_with_the_counted_nnz_c_equal_scipys(name, monkeypatch):
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb)
    # scipy's count as the plans took it before K5: the product of the
    # boolean matrices of the stored values (no stored zero here)
    old = int((sa.astype(bool) @ sb.astype(bool)).nnz)
    g_scipy = grouped.make_grouped_plan(a, b)
    t_scipy = tilepack.make_tilepack_plan(a, b)
    assert g_scipy.plan.nnz_c == old
    assert t_scipy is None or t_scipy.plan.nnz_c == old
    assert same_schedule(
        grouped.make_grouped_plan(a, b, nnz_c=_counted(a, b)), g_scipy)
    monkeypatch.setattr(tilepack, "exact_nnz_c", _counted)
    monkeypatch.setattr(grouped, "exact_nnz_c", _counted)
    assert same_schedule(grouped.make_grouped_plan(a, b), g_scipy)
    assert same_schedule(tilepack.make_tilepack_plan(a, b), t_scipy)


def _stored_zeros():
    """A whose row 0 holds only stored zeros, to 40 rows of B of one entry
    each: C's row 0 has 40 structural entries, all of value 0. The other
    rows are a plain random product."""
    rng = np.random.default_rng(2)
    n = 64
    a = sp.random(n, n, density=0.05, random_state=rng, format="lil",
                  dtype=np.float32)
    b = sp.random(n, n, density=0.05, random_state=rng, format="lil",
                  dtype=np.float32)
    a[0, :] = 0
    b[:40, :] = 0
    for j in range(40):
        b[j, j] = 1.0
    a, b = a.tocsr(), b.tocsr()
    indptr = np.concatenate([[0], a.indptr[1:] + 40])
    a = sp.csr_matrix(
        (np.concatenate([np.zeros(40, np.float32), a.data]),
         np.concatenate([np.arange(40, dtype=np.int32), a.indices]), indptr),
        shape=(n, n))
    return a, b


@pytest.mark.parametrize("method", ["grouped", "tilepack"])
def test_a_stored_zero_counts_as_the_numeric_key_set_does(method):
    """The plans count structure, not values: the numeric phases keep a C
    entry whose every term meets a stored zero (value 0), so nnz(C) is
    scipy's pattern count and the output fills exactly that many slots.
    The product of boolean matrices of the values misses those entries."""
    sa, sb = _stored_zeros()
    a, b = csrs(sa, sb)
    rows = pattern_counts(sa, sb)
    by_values = int((sa.astype(bool) @ sb.astype(bool)).nnz)
    assert by_values == int(rows.sum()) - 40
    np.testing.assert_array_equal(symbolic.nnz_rows(a, b).numpy(), rows)
    if method == "grouped":
        sched = grouped.make_grouped_plan(a, b)
        c = grouped.spgemm_grouped(a, b, sched)
    else:
        sched = tilepack.make_tilepack_plan(a, b)
        c = tilepack.spgemm_tilepack(a, b, sched)
    assert sched.plan.nnz_c == int(rows.sum())
    np.testing.assert_array_equal(np.diff(c.rowptr.numpy()), rows)
    assert int(c.rowptr[-1]) <= sched.plan.out_cap
    np.testing.assert_array_equal(c.colidx[:40].numpy(), np.arange(40))
    assert not c.vals[:40].any()
    np.testing.assert_allclose(c.to_scipy().toarray(), (sa @ sb).toarray(),
                               rtol=1e-5, atol=1e-6)


# -- on the card -----------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_k5_equals_its_plain_version(name):
    need_card()
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb, "cuda")
    before = symbolic.nnz_rows.launches
    got = symbolic.nnz_rows(a, b)
    torch.cuda.synchronize()
    assert symbolic.nnz_rows.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = symbolic.nnz_rows(*csrs(sa, sb))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert symbolic.exact_nnz_c(a, b) == int(want.sum())


@pytest.mark.cuda
def test_k5_counts_are_the_same_every_run():
    need_card()
    a, b = csrs(*_bins(), "cuda")
    first = symbolic.nnz_rows(a, b)
    for _ in range(5):
        assert torch.equal(symbolic.nnz_rows(a, b), first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BENCH + ("rect", "bins", "walk", "wide"))
def test_plans_built_on_the_card_equal_the_cpus(name):
    """The grouped and tilepack plans counted by K5 equal those scipy's
    count builds on the CPU, field for field; each plan built on the card
    launches K5 once, and a grouped plan given nnz_c launches it never."""
    need_card()
    sa, sb = PAIRS[name]()
    a, b = csrs(sa, sb, "cuda")
    ca, cb = csrs(sa, sb)
    for make in (grouped.make_grouped_plan, tilepack.make_tilepack_plan):
        want = make(ca, cb)
        before = symbolic.nnz_rows.launches
        got = make(a, b)
        assert same_schedule(got, want), make.__name__
        reached = want is not None
        assert symbolic.nnz_rows.launches - before == int(reached)
    before = symbolic.nnz_rows.launches
    grouped.make_grouped_plan(a, b, nnz_c=_counted(ca, cb))
    assert symbolic.nnz_rows.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["grouped", "tilepack"])
def test_a_stored_zero_counts_on_the_card(method):
    need_card()
    sa, sb = _stored_zeros()
    a, b = csrs(sa, sb, "cuda")
    make = (grouped.make_grouped_plan if method == "grouped"
            else tilepack.make_tilepack_plan)
    assert same_schedule(make(a, b), make(*csrs(sa, sb)))
    np.testing.assert_array_equal(symbolic.nnz_rows(a, b).cpu().numpy(),
                                  pattern_counts(sa, sb))
