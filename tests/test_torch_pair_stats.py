"""Kernel K7's plain version (``ops/pair_stats.pair_stats_plain``) and the
dispatcher that prices from it (``ops/dispatch``).

The integers must equal what the dispatcher's numpy passes over host
copies computed before K7 (``old_integers``: products, ceil sums, chunk
counts, tilepack's greedy fill row by row, the diagonals' sorted offsets,
bsr's block pairs); every ``estimate_*_s`` must return the same float as
that numpy arithmetic (``old_estimates``, ``inf`` for ``inf``), and
``choose_method`` the same pick, and the JAX package's where
``tests/test_torch_api.py`` holds it to it. K7's own fill (segments of
rows run from every state of the open tile, then chained) is replayed in
numpy against the plain version's pointer doubling. The tests marked
``cuda`` hold K7 to its plain version on the card; run them there without
the repository's conftest:

    python -m pytest tests/test_torch_pair_stats.py -m cuda --noconftest -q
"""
import functools
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch, pair_stats
from benchmark_spgemm_using_csr_tpu_torch.ops.grouped import estimate_mode_ns
from benchmark_spgemm_using_csr_tpu_torch.ops.stream import (
    F32_PACKABLE,
    pad_gentle,
    rc_pack_bits,
)
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR
from benchmark_spgemm_using_csr_tpu_torch.utils import generators

torch.set_num_threads(2)

ORDER = ("chunked", "bsr", "dia", "dense", "tilepack", "grouped", "hash")


# -- the dispatcher's numpy passes before K7, repeated -----------------------


def _host(x: CSR):
    rowptr = x.rowptr.numpy().astype(np.int64)
    nnz = int(rowptr[-1])
    return rowptr, nnz, np.diff(rowptr), x.colidx.numpy()[:nnz].astype(
        np.int64)


def _old_fill(row_chunks, wlr):
    """tilepack's greedy fill, row by row: (tiles, most rows in a tile)."""
    ranks, cur, rank = [0], 0, 0
    for c in row_chunks.tolist():
        if c == 0:
            continue
        if cur + c > wlr:
            ranks.append(rank)
            cur = 0
        cur += c
        rank += 1
    ranks.append(rank)
    return len(ranks) - 1, int(np.diff(ranks).max(initial=1))


def _old_tilepack(a, b):
    """make_tilepack_plan's statics (w, wlr, t_cap, wlr_eff, abpad_cap),
    its tiles and most rows a tile, or None where it refuses."""
    m, n = a.m, b.n
    if m == 0 or n == 0 or a.vals.dtype not in F32_PACKABLE:
        return None
    a_rowptr, nnz_a, _, cols = _host(a)
    _, _, b_len, _ = _host(b)
    lens = b_len[cols]
    total = int(lens.sum())
    if total == 0 or total > (1 << 27):
        return None
    al = 8
    chunks_e = -(-lens // al)
    n_zero = int((chunks_e == 0).sum())
    if n_zero <= max(nnz_a // 16, 64):
        chunks_e = np.maximum(chunks_e, 1)
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    row_chunks = cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]
    max_chunks = int(row_chunks.max(initial=0))
    w = max(128, 1 << int(al * max(max_chunks, 1) - 1).bit_length())
    if al * max_chunks > w or w > 2048:
        return None
    wlr = w // al
    cbits = max(int(n - 1).bit_length(), 1)
    tiles, most = _old_fill(row_chunks, wlr)
    wlr_eff = max(1 << max(int(most - 1).bit_length(), 0), 1)
    if int(wlr_eff - 1).bit_length() + cbits > 30:
        return None
    abpad = int((-(-b_len // al) * al).sum())
    abpad_cap = max(-(-pad_gentle(abpad + al) // al) * al, al)
    return dict(w=w, wlr=wlr, t_cap=pad_gentle(tiles), wlr_eff=wlr_eff,
                abpad_cap=abpad_cap, tiles=tiles, most=most)


def _sorted_unique(x):
    s = np.sort(x)
    keep = np.ones(s.shape, bool)
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _old_offsets(x):
    rowptr, _, lens, cols = _host(x)
    rows = np.repeat(np.arange(x.m, dtype=np.int64), lens)
    return _sorted_unique(cols - rows)


def _old_bsr_pairs(a, b):
    bm, bk, bn = 8, 128, 128
    a_rowptr, _, _, a_cols = _host(a)
    b_rowptr, _, _, b_cols = _host(b)
    a_rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(a_rowptr))
    a_keys = _sorted_unique((a_rows // bm) * (a.n // bk) + a_cols // bk)
    b_rows = np.repeat(np.arange(b.m, dtype=np.int64), np.diff(b_rowptr))
    b_keys = _sorted_unique((b_rows // bk) * (b.n // bn) + b_cols // bn)
    b_blen = np.bincount(b_keys // (b.n // bn), minlength=b.m // bk)
    return int(b_blen[a_keys % (a.n // bk)].sum())


def old_integers(a, b):
    """The integers of ``pair_stats.FIELDS`` and the offsets, computed as
    the dispatcher's numpy passes computed them."""
    a_rowptr, nnz_a, a_lens, cols = _host(a)
    _, nnz_b, b_len, _ = _host(b)
    lens = b_len[cols]
    chunks_e = -(-lens // 8)
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    row_chunks = cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]
    zeros = np.concatenate([[0], np.cumsum(lens == 0)])
    row_zero = zeros[a_rowptr[1:]] - zeros[a_rowptr[:-1]]
    got = dict(
        nnz_a=nnz_a, nnz_b=nnz_b, products=int(lens.sum()),
        rows_ne=int((a_lens > 0).sum()), n_zero=int((lens == 0).sum()),
        **{f"slots{c}": int((-(-lens // c)).sum()) for c in (2, 4, 8)},
        **{f"pad{c}": int((-(-b_len // c)).sum()) for c in (2, 4, 8)},
        max_chunks=int(row_chunks.max(initial=0)),
        max_chunks_set=int((row_chunks + row_zero).max(initial=0)),
        tiles=0, max_rows=0)
    gate = pair_stats.fill_width(got)
    if gate is not None:
        got["tiles"], got["max_rows"] = _old_fill(
            row_chunks + row_zero if gate[1] else row_chunks, gate[0] // 8)
    offs_a, offs_b = _old_offsets(a), _old_offsets(b)
    got.update(nd_a=len(offs_a), nd_b=len(offs_b), bsr_pairs=None,
               offs_a=tuple(offs_a.tolist()) if len(offs_a) <= 4096 else None,
               offs_b=tuple(offs_b.tolist()) if len(offs_b) <= 4096 else None)
    if not (a.m % 8 or a.n % 128 or b.m % 128 or b.n % 128):
        got["bsr_pairs"] = _old_bsr_pairs(a, b)
    return got


def old_estimates(a, b):
    """The seven estimates as the numpy passes priced them."""
    D = dispatch
    m, k, n = a.m, a.n, b.n
    a_rowptr, nnz_a, a_lens, cols = _host(a)
    _, nnz_b, b_len, _ = _host(b)
    lens = b_len[cols]
    products = int(lens.sum()) if nnz_a else 0
    itemsize = a.vals.element_size()
    out = {}
    # chunked
    cbits = max(int(max(n - 1, 1)).bit_length(), 1)
    rbits = max(int(max(m - 1, 1)).bit_length(), 1)
    if rc_pack_bits(m, n) > 0 or cbits + rbits <= 32:
        ns = D.CHUNKED_NS_PER_PRODUCT
    else:
        ns = D.CHUNKED_NS_PER_PRODUCT_UNPACKED + D.CHUNKED_NS_M_TAIL * m / max(
            products, 1)
    out["chunked"] = D.CHUNKED_FIXED_S + products * ns * 1e-9
    # bsr
    if a.m % 8 or a.n % 128 or b.m % 128 or b.n % 128:
        out["bsr"] = float("inf")
    elif not nnz_a or not nnz_b:
        out["bsr"] = 0.0
    else:
        pairs = _old_bsr_pairs(a, b)
        out["bsr"] = (float("inf") if pairs * 8 * 128 * 4 > D.BSR_PAIR_BYTES
                      else D.BSR_FIXED_S + pairs * D.BSR_NS_PER_PAIR * 1e-9)
    # dia
    if not nnz_a or not nnz_b:
        out["dia"] = 0.0
    else:
        offs_a, offs_b = _old_offsets(a), _old_offsets(b)
        nd_a, nd_b = len(offs_a), len(offs_b)
        term_cap = 16384 if products >= (1 << 22) else 8192
        if (nd_a * nd_b * n * D.DIA_NS_PER_SLOT * 1e-9 > 10.0 or nd_a > 4096
                or nd_b > 4096 or nd_a * nd_b > term_cap):
            out["dia"] = float("inf")
        else:
            n_off_c = len(np.unique(offs_a[:, None] + offs_b[None, :]))
            if n_off_c * n * itemsize > D.DIA_PLANE_BYTES:
                out["dia"] = float("inf")
            else:
                out["dia"] = (D.DIA_FIXED_S
                              + nd_a * nd_b * n * D.DIA_NS_PER_SLOT * 1e-9
                              + (nd_a * nd_b / max(nd_a, nd_b, 1))
                              * D.DIA_OP_OVERHEAD_S)
    # dense
    if (m * k + k * n + m * n) * itemsize > D.DENSE_MEM_BYTES:
        out["dense"] = float("inf")
    else:
        passes = max(int(m * n).bit_length() - 8, 1)
        out["dense"] = (D.DENSE_FIXED_S
                        + 2.0 * m * k * n / D.MXU_F32_HIGHEST_FLOPS
                        + (nnz_a + nnz_b) / D.SCATTER_DESC_PER_S
                        + passes * (m * n * (2 * itemsize + 1))
                        / D.HBM_BYTES_PER_S)
    # tilepack
    if not nnz_a:
        out["tilepack"] = 0.0
    elif products > (1 << 27):
        out["tilepack"] = float("inf")
    else:
        p = _old_tilepack(a, b)
        if p is None:
            out["tilepack"] = float("inf")
        else:
            lanes = p["t_cap"] * p["w"]
            lw = max(int(p["w"] - 1).bit_length(), 1)
            kernel_ns = 0.0122 * lw * (lw + 1) / 2 + 0.173 * p["wlr_eff"]
            passes = max(int(max(lanes // 4, 1)).bit_length(), 1)
            out["tilepack"] = (D.CHUNKED_FIXED_S + 2 * nnz_a / 1.30e8
                               + p["abpad_cap"] / 2.28e8
                               + p["t_cap"] * p["wlr"] / 1.94e8
                               + lanes * kernel_ns * 1e-9
                               + passes * lanes * 0.075e-9)
    # grouped
    dtype = str(a.vals.dtype).replace("torch.", "")
    if not nnz_a or products == 0:
        out["grouped"] = 0.0
    elif (products > (1 << 27)
          or dtype not in ("float32", "bfloat16", "float16", "float64")
          or max(int(n - 1).bit_length(), 1) > 31):
        out["grouped"] = float("inf")
    else:
        cost = estimate_mode_ns(m, nnz_a, products, products, 0)
        for cand in (2, 4, 8):
            abpad_c = int((-(-b_len // cand) * cand).sum())
            slots_c = int((-(-lens // cand)).sum()) * cand
            if abpad_c // cand > (512 << 10 if cand < 8 else 2 << 20):
                continue
            cost = min(cost, estimate_mode_ns(m, nnz_a, slots_c,
                                              slots_c // cand, abpad_c))
        if dtype == "float64":
            cost *= 2.2
        out["grouped"] = D.CHUNKED_FIXED_S + cost * 1e-9
    # hash
    if not nnz_a:
        out["hash"] = 0.0
    else:
        budget = 512 * 1024 * 1024
        r_tile = max(int(budget // (n * (itemsize + 4 + 4))), 8)
        m_ne = int((a_lens > 0).sum())
        n_tiles = -(-m_ne // max(min(r_tile, m_ne), 1)) if m_ne else 0
        slots = n_tiles * min(r_tile, max(m_ne, 1)) * n
        out["hash"] = (D.CHUNKED_FIXED_S * max(n_tiles, 1)
                       + products / 1.30e8 + products / 1.94e8
                       + products / 2.28e8 + slots * 0.8e-9
                       + 2 * slots / 1.4e8)
    return out


def old_pick(a, b):
    _, nnz_a, _, cols = _host(a)
    if not nnz_a or int(_host(b)[2][cols].sum()) == 0:
        return "chunked"
    est = old_estimates(a, b)
    return min(ORDER, key=lambda name: (est[name], ORDER.index(name)))


# -- the matrices ------------------------------------------------------------


def _bench(name):
    gen = importlib.import_module(f"spgemm_bench.generators.{name}")
    rowptr, colidx, vals, shape = gen.generate(**gen.SMALL_PARAMS)
    a = sp.csr_matrix((vals, colidx, rowptr), shape=shape)
    return a, a


def _suite(name):
    a = generators.SUITE[name]()
    return a, a


def _rect():
    return generators.rect_pair(600, 300, 500, seed=7)


def _empty_b_rows(rows):
    """A's entries point at ``rows`` empty rows of B: few (each empty B row
    keeps a chunk, scatter_set) or many (it does not)."""
    rng = np.random.default_rng(5)
    a = sp.random(300, 300, density=0.05, random_state=rng, format="lil",
                  dtype=np.float32)
    b = a.copy()
    b[:rows, :] = 0
    return a.tocsr(), b.tocsr()


def _tile_edges():
    """B rows of 8 entries (a chunk an entry); A rows of 16 entries fill a
    128-lane tile (16 chunks) exactly, rows of 8 share one, and empty rows
    of A lie between tiles."""
    n = 256
    b = sp.csr_matrix(np.kron(np.eye(n // 8), np.ones((8, 8))) [:n, :n]
                      .astype(np.float32))
    rows, cols = [], []
    widths = [16, 0, 8, 8, 0, 0, 16, 8, 16, 0, 8, 8, 8, 16] * 4
    for r, w in enumerate(widths):
        rows += [r] * w
        cols += [(8 * j + r) % n for j in range(w)]
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(len(widths), n))
    return a, b


def _bsr_shapes():
    rng = np.random.default_rng(11)
    a = sp.random(256, 384, density=0.01, random_state=rng, format="csr",
                  dtype=np.float32)
    b = sp.random(384, 256, density=0.02, random_state=rng, format="csr",
                  dtype=np.float32)
    return a, b


def _diagonals(nd):
    """A square matrix with ``nd`` distinct diagonals, one entry each."""
    n = 8192
    d = np.arange(nd)
    r = d % 97
    a = sp.csr_matrix((np.ones(nd, np.float32), (r, r + d)), shape=(n, n))
    return a, a


def _zero():
    a = sp.csr_matrix((64, 64), dtype=np.float32)
    return a, a


BENCH = ("circuit", "poisson2d", "fem_irregular", "webbase")
# tests/test_torch_api.py's suite points (its DISPATCH) and AUTO's circuit
SUITE = ["er_small", "powerlaw_small", "poisson2d_64", "er_medium",
         "powerlaw_medium", "circuit_64k", "dense_rows_2k", "dense_rows_8k",
         "banded_16k", "stencil27_32", "hubrows_32k", "poisson2d_256",
         "econ_206k", "mc2depi_524k", "scircuit_256k", "fem_17k", "fem_32k",
         "pdb_8k", "femirr_17k", "pattern_circuit_64k", "fem_46k",
         "consph_83k"]
CASES = {
    **{f"bench_{name}": functools.partial(_bench, name) for name in BENCH},
    **{f"suite_{name}": functools.partial(_suite, name) for name in SUITE},
    "circuit_2048_seed3": lambda: (generators.circuit(2048, seed=3),) * 2,
    "rect_pair": _rect,
    "empty_b_rows_few": functools.partial(_empty_b_rows, 2),
    "empty_b_rows_many": functools.partial(_empty_b_rows, 150),
    "tile_edges": _tile_edges,
    "bsr_shapes": _bsr_shapes,
    "diagonals_4096": functools.partial(_diagonals, 4096),
    "diagonals_4097": functools.partial(_diagonals, 4097),
    "zero": _zero,
}


@functools.lru_cache(maxsize=4)
def csrs(name):
    sa, sb = CASES[name]()
    a = CSR.from_scipy(sa, device="cpu")
    b = a if sb is sa else CSR.from_scipy(sb, device="cpu")
    return a, b


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_integers_equal_the_numpy_passes(name):
    a, b = csrs(name)
    got = vars(pair_stats.pair_stats_plain(a, b))
    assert got == old_integers(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimates_and_pick_equal_the_numpy_passes(name):
    a, b = csrs(name)
    pair_stats._PSTATS.clear()
    want = old_estimates(a, b)
    for method in ORDER:
        got = getattr(dispatch, f"estimate_{method}_s")(a, b)
        assert got == want[method], method  # inf == inf
    assert dispatch.choose_method(a, b) == old_pick(a, b)


# the picks tests/test_torch_api.py holds to the JAX package's
@pytest.mark.parametrize("name", ["rect_pair", "circuit_2048_seed3"]
                         + [f"suite_{n}" for n in SUITE[:8]])
def test_pick_equals_the_reference(name):
    import benchmark_spgemm_using_csr_tpu as J

    sa, sb = CASES[name]()
    ja, jb = J.CSR.from_scipy(sa), J.CSR.from_scipy(sb)
    a, b = csrs(name)
    assert dispatch.choose_method(a, b) == J.choose_method(ja, jb)


def test_the_edge_cases_reach_their_branches():
    few = vars(pair_stats.pair_stats_plain(*csrs("empty_b_rows_few")))
    many = vars(pair_stats.pair_stats_plain(*csrs("empty_b_rows_many")))
    assert 0 < few["n_zero"] <= max(few["nnz_a"] // 16, 64)
    assert many["n_zero"] > max(many["nnz_a"] // 16, 64)
    assert few["tiles"] > 0 and many["tiles"] > 0
    edges = pair_stats.pair_stats_plain(*csrs("tile_edges"))
    assert (edges.max_chunks, edges.max_rows) == (16, 2)
    assert pair_stats.pair_stats_plain(*csrs("bsr_shapes")).bsr_pairs > 0
    at = pair_stats.pair_stats_plain(*csrs("diagonals_4096"))
    past = pair_stats.pair_stats_plain(*csrs("diagonals_4097"))
    assert at.nd_a == 4096 and at.offs_a == tuple(range(4096))
    assert past.nd_a == 4097 and past.offs_a is None
    assert dispatch.estimate_dia_s(*csrs("diagonals_4097")) == float("inf")


def test_pair_stats_holds_a_pair_by_its_buffers():
    a, b = csrs("rect_pair")
    pair_stats._PSTATS.clear()
    s = pair_stats.pair_stats(a, b)
    assert pair_stats.pair_stats(a, b) is s
    assert pair_stats.pair_stats(b, a) is not s
    c = CSR(a.rowptr.clone(), a.colidx, a.vals, a.shape)
    assert pair_stats.pair_stats(c, b) is not s  # another buffer
    assert pair_stats.pair_stats(c, b) == s


# -- K7's fill, replayed -------------------------------------------------------


def k7_fill(chunks, wlr, seg):
    """csrc/pair_stats.cu's fill in numpy: each segment of ``seg`` rows run
    from every state of the open tile (fill_segments), then the segments
    chained from state 0 (fill_combine)."""
    chunks = chunks.tolist()
    table = []
    for g in range(0, len(chunks), seg):
        part = chunks[g:g + seg]
        runs = []
        for s in range(wlr + 1):
            cur, opened, head, rows, most = s, 0, 0, 0, 0
            for c in part:
                if c == 0:
                    continue
                if cur + c > wlr:
                    if opened == 0:
                        head = rows
                    else:
                        most = max(most, rows)
                    opened += 1
                    cur, rows = 0, 0
                cur += c
                rows += 1
            if opened == 0:
                head = rows
            runs.append((cur, opened, head, rows, most))
        table.append(runs)
    state, tiles, rows, most = 0, 1, 0, 1
    for runs in table:
        end, opened, head, last, inner = runs[state]
        if opened == 0:
            rows += head
        else:
            most = max(most, rows + head, inner)
            rows = last
            tiles += opened
        state = end
    return tiles, max(most, rows)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("seg", [1, 3, 7, 64])
def test_k7_fill_equals_the_plain_fill(seed, seg):
    rng = np.random.default_rng(seed)
    wlr = int(rng.choice([16, 32, 256]))
    chunks = rng.integers(1, wlr + 1, 300) * (rng.random(300) < 0.8)
    chunks[rng.random(300) < 0.3] = rng.integers(1, 4)
    want = _old_fill(chunks, wlr)
    assert pair_stats.greedy_fill(chunks, wlr) == want
    assert k7_fill(chunks, wlr, seg) == want


# -- on the card -----------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


CARD_CASES = sorted(set(CASES) - {f"suite_{n}" for n in SUITE[8:]})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_k7_equals_its_plain_version(name):
    need_card()
    a, b = csrs(name)
    ga = CSR(a.rowptr.cuda(), a.colidx.cuda(), a.vals.cuda(), a.shape)
    gb = ga if b is a else CSR(b.rowptr.cuda(), b.colidx.cuda(),
                               b.vals.cuda(), b.shape)
    before = pair_stats.pair_stats.launches
    got = pair_stats.pair_stats(ga, gb)
    assert pair_stats.pair_stats.launches == before + 1
    assert got == pair_stats.pair_stats_plain(a, b)
    assert pair_stats.pair_stats(ga, gb) is got
    assert dispatch.choose_method(ga, gb) == dispatch.choose_method(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bsr_shapes", "suite_circuit_64k"])
def test_k7_bsr_bitmaps_in_device_memory_equal_its_plain_version(
        name, monkeypatch):
    """With no shared memory allowed, bsr's bitmaps take slices of device
    memory (the path of a matrix wider than ~50M columns)."""
    need_card()
    monkeypatch.setattr(pair_stats, "BSR_SMEM_BYTES", 0)
    a, b = csrs(name)
    ga = CSR(a.rowptr.cuda(), a.colidx.cuda(), a.vals.cuda(), a.shape)
    gb = ga if b is a else CSR(b.rowptr.cuda(), b.colidx.cuda(),
                               b.vals.cuda(), b.shape)
    want = pair_stats.pair_stats_plain(a, b)
    assert want.bsr_pairs
    assert pair_stats._launch(ga, gb) == want
