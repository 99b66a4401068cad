"""Kernels K1 (tile_sort_merge), K2 (bin_sort_compress), K3
(dia_spgemm_fused) and K4 (dia_to_csr) of the PyTorch port.

The plain PyTorch versions of K1 and K2 are held against the reference's
Pallas kernels run in interpret mode on the same inputs: keys / columns,
positions and counts exactly, values within rtol 1e-6 / atol 1e-6 (the
same addition tree, so in practice bit for bit; the tolerance covers
-0.0/+0.0 ties). K3's plain version is held against its Pallas kernel in
tests/test_torch_dia.py. The CUDA kernels are held against the plain
versions on the card by tests that need a CUDA device and skip without
one (K3 bit for bit: both sum each plane in one order without FMA; K4
bit for bit: it copies values; its plain version is held against the
reference in tests/test_torch_dia_to_csr.py); on
the card, where jax is not installed, run them without the repository's
conftest:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from benchmark_spgemm_using_csr_tpu_torch.ops import (
    dia,
    dia_convert,
    dia_kernels,
    kernels,
)
from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import DIA
from benchmark_spgemm_using_csr_tpu_torch.utils import generators

torch.set_num_threads(2)

SENTINEL = 1 << 30
TOL = dict(rtol=1e-6, atol=1e-6)


def tiles(w: int, wlr: int, cbits: int, seed: int):
    """Six tile rows, one per case: random keys with sentinel holes, heavy
    duplicates (few keys, equal (key, val) pairs), an all-sentinel tile, a
    single live lane, a single live lane stored in the last lane, and a
    full tile with no sentinel, whose largest key sorts to lane W-1 and is
    a tail by the last-lane rule."""
    rng = np.random.default_rng(seed)
    r = 6
    key = rng.integers(0, wlr << cbits, size=(r, w)).astype(np.int32)
    val = rng.standard_normal((r, w)).astype(np.float32)
    key[0, rng.random(w) < 0.3] = SENTINEL
    key[1] = rng.integers(0, 3, size=w)  # heavy duplicates
    val[1] = np.round(val[1])
    key[2] = SENTINEL  # all-sentinel tile
    key[3] = SENTINEL
    key[3, w // 3] = (wlr - 1) << cbits  # single live lane
    key[4, : w - 1] = SENTINEL
    key[4, w - 1] = (wlr << cbits) - 1  # largest live key, last lane
    return key, val


# every width of K1's launch switch (the Pallas contract, 128..2048)
CASES = [(w, wlr) for w in (128, 256, 512, 1024, 2048) for wlr in (1, 4, 16)]


@pytest.mark.parametrize("w,wlr", CASES, ids=[f"W{w}-wlr{l}" for w, l in CASES])
def test_plain_matches_pallas(w, wlr):
    # imported here, so that the CUDA test of this file runs where jax is
    # not installed (the card's machine)
    import jax.numpy as jnp

    from benchmark_spgemm_using_csr_tpu.ops.pallas_kernels import (
        tile_sort_merge as pallas_tile_sort_merge,
    )

    cbits = 6
    key, val = tiles(w, wlr, cbits, seed=w + wlr)
    want = [np.asarray(x) for x in pallas_tile_sort_merge(
        jnp.asarray(key), jnp.asarray(val), sentinel=SENTINEL, wlr=wlr,
        cbits=cbits, interpret=True)]
    before = kernels.tile_sort_merge.launches
    got = [x.numpy() for x in kernels.tile_sort_merge(
        torch.from_numpy(key), torch.from_numpy(val), sentinel=SENTINEL,
        wlr=wlr, cbits=cbits)]
    # the CPU path runs the plain version and launches nothing
    assert kernels.tile_sort_merge.launches == before
    np.testing.assert_array_equal(got[0], want[0])  # okey
    np.testing.assert_array_equal(got[2], want[2])  # pos
    np.testing.assert_array_equal(got[3], want[3])  # cnt
    np.testing.assert_allclose(got[1], want[1], **TOL)  # oval
    assert got[3].shape == (key.shape[0], wlr)
    assert (got[3][2] == 0).all() and got[3][3].sum() == 1
    assert got[2][4, 0] == 0 and got[0][4, 0] == (wlr << cbits) - 1
    assert got[2][5, -1] < w and got[0][5, -1] == key[5].max()


@pytest.mark.parametrize("bad,exc", [
    (dict(key=np.zeros((2, 96), np.int32)), ValueError),  # not pow2
    (dict(key=np.zeros((2, 128), np.int64)), TypeError),
    (dict(val=np.zeros((2, 128), np.float64)), TypeError),
    (dict(val=np.zeros((2, 64), np.float32)), ValueError),  # shape
    (dict(wlr=0), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    args = dict(key=np.zeros((2, 128), np.int32),
                val=np.zeros((2, 128), np.float32), wlr=4)
    args.update(bad)
    with pytest.raises(exc):
        kernels.tile_sort_merge(torch.from_numpy(args["key"]),
                                torch.from_numpy(args["val"]),
                                sentinel=SENTINEL, wlr=args["wlr"], cbits=6)


def test_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA raises: the wrapper
    never quietly runs the plain version for a device tensor."""
    key = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    val = torch.zeros((2, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.tile_sort_merge(key, val, sentinel=SENTINEL, wlr=4, cbits=6)


def on_card(a: np.ndarray, offset: int = 0):
    """``a`` as a contiguous CUDA tensor; ``offset`` elements into its
    buffer, so that it is not 16-byte aligned and the kernels take their
    scalar loads."""
    buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a).dtype,
                      device="cuda")
    out = buf[offset:].view(a.shape)
    out.copy_(torch.from_numpy(a))
    return out


# every width with aligned inputs, and one with unaligned views
CUDA_CASES = [(w, wlr, 0) for w, wlr in CASES] + [(1024, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,wlr,offset", CUDA_CASES,
    ids=[f"W{w}-wlr{l}" + ("-unaligned" if o else "")
         for w, l, o in CUDA_CASES])
def test_cuda_kernel_matches_plain(w, wlr, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cbits = 7
    key, val = tiles(w, wlr, cbits, seed=w)
    # 301 rows: the last block of several rows per block is ragged
    key = on_card(np.tile(key, (51, 1))[:301], offset)
    val = on_card(np.tile(val, (51, 1))[:301], offset)
    kw = dict(sentinel=SENTINEL, wlr=wlr, cbits=cbits)
    before = kernels.tile_sort_merge.launches
    got = kernels.tile_sort_merge(key, val, **kw)
    want = kernels.tile_sort_merge_plain(key, val, **kw)
    torch.cuda.synchronize()
    assert kernels.tile_sort_merge.launches == before + 1
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[1], want[1], **TOL)


@pytest.mark.cuda
def test_cuda_kernel_rejects_non_contiguous():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    key = torch.zeros((128, 4), dtype=torch.int32, device="cuda").t()
    val = torch.zeros((4, 128), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.tile_sort_merge(key, val, sentinel=SENTINEL, wlr=4, cbits=6)


# ---- K2: bin_sort_compress --------------------------------------------------

K2_WIDTHS = [2, 4, 8, 16, 32, 64, 128, 512]
# every width of K2's launch switch with aligned inputs, two unaligned
K2_CUDA_CASES = [(1 << i, 0) for i in range(1, 12)] + [(8, 1), (512, 1)]


def bin_tiles(w: int, n: int, seed: int, rows: int = 8):
    """Rows of gathered products, one case each: random columns with
    sentinel holes, heavy duplicates (equal (col, val) pairs too), an
    all-sentinel row, a single live lane, a single live lane in the last
    lane, a full row with no sentinel, and two more random rows."""
    rng = np.random.default_rng(seed)
    col = rng.integers(0, n, size=(rows, w)).astype(np.int32)
    val = rng.standard_normal((rows, w)).astype(np.float32)
    col[0, rng.random(w) < 0.3] = n
    col[1] = rng.integers(0, 3, size=w)  # heavy duplicates
    val[1] = np.round(val[1])
    col[2] = n  # all-sentinel row
    col[3] = n
    col[3, w // 3] = n - 1  # single live lane
    col[4, : w - 1] = n
    col[4, w - 1] = 0  # live lane stored last, sorting first
    col[6, rng.random(w) < 0.7] = n
    return col, val


@pytest.mark.parametrize("w", K2_WIDTHS, ids=[f"W{w}" for w in K2_WIDTHS])
def test_k2_plain_matches_pallas(w):
    import jax.numpy as jnp

    from benchmark_spgemm_using_csr_tpu.ops.pallas_kernels import (
        bin_sort_compress as pallas_bin_sort_compress,
    )

    n = 5 * w
    col, val = bin_tiles(w, n, seed=w)
    want = [np.asarray(x) for x in pallas_bin_sort_compress(
        jnp.asarray(col), jnp.asarray(val), n_sentinel=n, interpret=True)]
    before = kernels.bin_sort_compress.launches
    got = [x.numpy() for x in kernels.bin_sort_compress(
        torch.from_numpy(col), torch.from_numpy(val), n_sentinel=n)]
    assert kernels.bin_sort_compress.launches == before  # CPU: plain
    np.testing.assert_array_equal(got[0], want[0])  # ocol
    np.testing.assert_array_equal(got[2], want[2])  # pos
    np.testing.assert_array_equal(got[3], want[3])  # counts
    np.testing.assert_allclose(got[1], want[1], **TOL)  # oval
    assert got[3].shape == (col.shape[0],) and got[3].dtype == np.int32
    assert got[3][2] == 0 and got[3][3] == 1 and got[3][4] == 1
    assert got[0][4, 0] == 0 and got[2][4, 0] == 0
    assert (got[0][2] == n).all() and (got[2][2] == w).all()


@pytest.mark.parametrize("bad,exc", [
    (dict(col=np.zeros((2, 12), np.int32)), ValueError),  # not pow2
    (dict(col=np.zeros((2, 8), np.int64)), TypeError),
    (dict(val=np.zeros((2, 8), np.float16)), TypeError),
    (dict(val=np.zeros((2, 16), np.float32)), ValueError),  # shape
    (dict(n=0), ValueError),  # sentinel
])
def test_k2_wrapper_rejects_bad_inputs(bad, exc):
    args = dict(col=np.zeros((2, 8), np.int32),
                val=np.zeros((2, 8), np.float32), n=16)
    args.update(bad)
    with pytest.raises(exc):
        kernels.bin_sort_compress(torch.from_numpy(args["col"]),
                                  torch.from_numpy(args["val"]),
                                  n_sentinel=args["n"])


def test_k2_no_fallback_off_cpu():
    col = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    val = torch.zeros((2, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.bin_sort_compress(col, val, n_sentinel=16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,offset", K2_CUDA_CASES,
    ids=[f"W{w}" + ("-unaligned" if o else "") for w, o in K2_CUDA_CASES])
def test_k2_cuda_kernel_matches_plain(w, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 7 * w
    col, val = bin_tiles(w, n, seed=w + 1)
    # 299 rows: the last block of several rows per block is ragged
    col = on_card(np.tile(col, (38, 1))[:299], offset)
    val = on_card(np.tile(val, (38, 1))[:299], offset)
    before = kernels.bin_sort_compress.launches
    got = kernels.bin_sort_compress(col, val, n_sentinel=n)
    want = kernels.bin_sort_compress_plain(col, val, n_sentinel=n)
    torch.cuda.synchronize()
    assert kernels.bin_sort_compress.launches == before + 1
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[1], want[1], **TOL)


def test_k2_plain_float64_matches_pallas():
    """K2 takes the values' own type, as the Pallas kernel does: float64
    values merge in float64. Columns, positions and counts do not depend on
    the values (the reference's float32 run); the merged values are held
    against a float64 sum per (row, column)."""
    import jax.numpy as jnp

    from benchmark_spgemm_using_csr_tpu.ops.pallas_kernels import (
        bin_sort_compress as pallas_bin_sort_compress,
    )

    w, n = 32, 5 * 32
    col, val32 = bin_tiles(w, n, seed=5)
    val = val32.astype(np.float64) * (1 + 1e-9 * np.arange(w))
    want = [np.asarray(x) for x in pallas_bin_sort_compress(
        jnp.asarray(col), jnp.asarray(val32), n_sentinel=n, interpret=True)]
    got = [x.numpy() for x in kernels.bin_sort_compress(
        torch.from_numpy(col), torch.from_numpy(val), n_sentinel=n)]
    assert got[1].dtype == np.float64
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for r in range(col.shape[0]):
        live = col[r] < n
        sums = np.zeros(n + 1)
        np.add.at(sums, col[r][live], val[r][live])
        tails = got[0][r] < n
        np.testing.assert_allclose(got[1][r][tails], sums[got[0][r][tails]],
                                   rtol=1e-12, atol=1e-12)
        assert (got[1][r][~tails] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128, 2048], ids=["W8", "W128", "W2048"])
def test_k2_cuda_float64_matches_plain(w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 7 * w
    col, val = bin_tiles(w, n, seed=11)
    col = on_card(np.tile(col, (38, 1))[:299])
    val = on_card(np.tile(val, (38, 1))[:299].astype(np.float64))
    got = kernels.bin_sort_compress(col, val, n_sentinel=n)
    want = kernels.bin_sort_compress_plain(col, val, n_sentinel=n)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.float64
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=1e-12)


# ---- K3: dia_spgemm_fused ---------------------------------------------------


def dia_operand(n: int, offsets, seed: int, m=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    return DIA.from_numpy(data, sorted(offsets), (m or n, n), device="cuda")


def unaligned_operand(n: int, offsets, seed: int) -> DIA:
    """Contiguous planes that start 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(
        rng.standard_normal(len(offsets) * n + 1).astype(np.float32)).cuda()
    data = flat[1:].view(len(offsets), n)
    rows = np.arange(n)[None, :] - np.asarray(offsets)[:, None]
    data[torch.from_numpy((rows < 0) | (rows >= n)).cuda()] = 0
    assert data.data_ptr() % 16 == 4
    return DIA(data, tuple(offsets), (n, n))


def suite_operand(mat) -> DIA:
    return DIA.from_scipy(mat, device="cuda")


K3_CASES = {
    "poisson": lambda: (dia_operand(4096, (-64, -1, 0, 1, 64), 0),) * 2,
    "banded_ab": lambda: (dia_operand(5000, range(-3, 4), 1),
                          dia_operand(5000, range(-5, 6), 2)),
    "ragged_n": lambda: (dia_operand(4097 + 300, (-7, 0, 2), 3),) * 2,
    "rectangular": lambda: (dia_operand(430, (0, 3), 4, m=400),
                            dia_operand(500, (-3, 2), 5, m=430)),
    "float64": lambda: (dia_operand(3000, (-9, 0, 4), 6, dtype=np.float64),
                        dia_operand(3000, (-2, 0, 11), 7, dtype=np.float64)),
    "many_planes": lambda: (dia_operand(2048, range(-13, 14), 8),) * 2,
    "diagonals_99": lambda: (suite_operand(
        generators.fem(6, dof=3, fill=0.9, seed=5)),) * 2,
    "stencil27": lambda: (suite_operand(generators.stencil27(12)),) * 2,
    "n_below_one_tile": lambda: (dia_operand(20, (-7, 0, 2), 10),) * 2,
    "span_4096": lambda: (dia_operand(9000, (-2048, -1, 0, 1, 2048), 11),) * 2,
    "unaligned_view": lambda: (unaligned_operand(3001, (-5, 0, 1, 40), 12),
                               unaligned_operand(3001, (-1, 0, 7), 13)),
    "float64_widest_window": lambda: (
        dia_operand(4000, range(-32, 33, 2), 14, dtype=np.float64),) * 2,
    "direct_mode": lambda: (
        dia_operand(700, range(-150, 150), 15, dtype=np.float64),) * 2,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_k3_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = K3_CASES[name]()
    before = dia_kernels.dia_spgemm_fused.launches
    got = dia_kernels.dia_spgemm_fused(a, b)
    want = dia_kernels.dia_spgemm_fused_plain(a, b)
    torch.cuda.synchronize()
    assert dia_kernels.dia_spgemm_fused.launches == before + 1
    assert got.offsets == want.offsets and got.dtype == want.dtype
    assert torch.equal(got.data, want.data)


@pytest.mark.cuda
def test_k3_cuda_auto_gate_launches_k3_on_27_diagonals():
    """dia_spgemm(fused=None) takes K3 for CUDA planes within its span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = suite_operand(generators.stencil27(16))
    before = dia_kernels.dia_spgemm_fused.launches
    c = dia.dia_spgemm(a, a)
    torch.cuda.synchronize()
    assert dia_kernels.dia_spgemm_fused.launches == before + 1
    assert torch.equal(c.data, dia.dia_spgemm(a, a, fused=False).data)


@pytest.mark.cuda
def test_k3_cuda_span_past_4096_launches_k3():
    """dia_spgemm(fused=None) takes K3 with bj widened for a B span past
    the reference's 4096 (consph_83k's 5590), bit-equal to the gather
    form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = dia_operand(83334, (-4600, -1, 0, 1, 990), 11)
    before = dia_kernels.dia_spgemm_fused.launches
    c = dia.dia_spgemm(a, a)
    torch.cuda.synchronize()
    assert dia_kernels.dia_spgemm_fused.launches == before + 1
    want = dia_kernels.gather_form(a, a)
    assert c.offsets == want.offsets
    assert torch.equal(c.data, want.data)


@pytest.mark.cuda
def test_k3_cuda_empty_operand_and_span_guard():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = dia_operand(1024, (-1, 0, 1), 9)
    empty = DIA(torch.zeros((0, 1024), device="cuda"), (), (1024, 1024))
    before = dia_kernels.dia_spgemm_fused.launches
    c = dia_kernels.dia_spgemm_fused(a, empty)
    assert dia_kernels.dia_spgemm_fused.launches == before
    assert c.offsets == (0,) and not c.data.any()
    with pytest.raises(ValueError, match="span"):
        dia_kernels.dia_spgemm_fused(a, a, bj=1)


# ---- K4: dia_to_csr ----------------------------------------------------------


def squared_on_card(mat) -> DIA:
    """The planes of C = A @ A (K3), as the dia path hands them on."""
    a = suite_operand(mat)
    return dia.dia_spgemm(a, a)


def with_zeros(d: DIA, seed: int) -> DIA:
    """A quarter of the slots set to 0.0, another quarter to -0.0, one
    plane all 0, and rows 1 and 2 holding only zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(d.data.shape, device="cuda", generator=g)
    d.data[u < 0.25] = 0.0
    d.data[(u >= 0.25) & (u < 0.5)] = -0.0
    d.data[1] = 0
    for s, off in enumerate(d.offsets):
        for r in (1, 2):
            if 0 <= r + off < d.n:
                d.data[s, r + off] = 0
    return d


K4_CASES = {
    "poisson2d_724": lambda: squared_on_card(generators.poisson2d(724)),
    "stencil27_32": lambda: squared_on_card(generators.stencil27(32)),
    "diagonals_99": lambda: suite_operand(
        generators.fem(6, dof=3, fill=0.9, seed=5)),
    "n_below_one_block": lambda: dia_operand(20, (-7, 0, 2), 10),
    "wide": lambda: dia_operand(430, (-2, 0, 3, 17, 420), 4, m=400),
    "tall": lambda: dia_operand(300, (-310, -3, 0, 5), 5, m=700),
    "zeros": lambda: with_zeros(dia_operand(5000, range(-4, 5), 1), 1),
    "float64": lambda: with_zeros(dia_operand(3000, (-9, 0, 4), 6,
                                              dtype=np.float64), 2),
    "float64_three_passes": lambda: dia_operand(
        4000, range(-32, 33, 2), 14, dtype=np.float64),
    "unaligned_view": lambda: unaligned_operand(3001, (-5, 0, 1, 40), 12),
}


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.is_floating_point():
        view = torch.int64 if x.element_size() == 8 else torch.int32
        x, y = x.view(view), y.view(view)
    return x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [True, False], ids=["prune", "keep"])
@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_k4_cuda_kernel_matches_plain(name, prune):
    """Bit for bit, at one launch a call: rowptr, colidx and vals over the
    whole capacity (zero past nnz)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = K4_CASES[name]()
    before = dia_convert.dia_to_csr.launches
    got = dia_convert.dia_to_csr(d, prune)
    want = dia_convert.dia_to_csr_plain(d, prune)
    torch.cuda.synchronize()
    assert dia_convert.dia_to_csr.launches == before + 1
    assert got.capacity == want.capacity
    for x, y in ((got.rowptr, want.rowptr), (got.colidx, want.colidx),
                 (got.vals, want.vals)):
        assert same_bits(x, y)


@pytest.mark.cuda
def test_k4_cuda_calls_nothing_that_synchronises():
    """After the first call (the build and the plan's one copy of the
    offsets), ``DIA.to_csr`` on the card neither syncs nor reads back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = squared_on_card(generators.poisson2d(64))
    d.to_csr(prune=True)
    torch.cuda.synchronize()
    before = dia_convert.dia_to_csr.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [d.to_csr(prune=p) for p in (True, False, True)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dia_convert.dia_to_csr.launches == before + 3
    for c, p in zip(outs, (True, False, True)):
        want = dia_convert.dia_to_csr_plain(d, p)
        assert same_bits(c.rowptr, want.rowptr)
        assert same_bits(c.colidx, want.colidx)
        assert same_bits(c.vals, want.vals)


@pytest.mark.cuda
def test_k4_cuda_edges_and_what_it_refuses():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = dia_convert.dia_to_csr.launches
    empty = DIA(torch.zeros((0, 9), device="cuda"), (), (9, 9)).to_csr()
    assert empty.capacity == 8 and not empty.rowptr.any()
    assert dia_convert.dia_to_csr.launches == before
    no_rows = DIA(torch.zeros((2, 9), device="cuda"), (0, 1), (0, 9))
    got = no_rows.to_csr()
    assert dia_convert.dia_to_csr.launches == before + 1
    assert got.rowptr.tolist() == [0] and got.capacity == 8
    assert not got.colidx.any() and not got.vals.any()
    d = dia_operand(1000, (-3, 0, 3), 3)
    wide = torch.zeros((3, 2000), device="cuda")
    wide[:, ::2] = d.data
    with pytest.raises(ValueError, match="contiguous"):
        dia_convert.dia_to_csr(DIA(wide[:, ::2], d.offsets, d.shape))
    with pytest.raises(TypeError, match="float32 or float64"):
        dia_convert.dia_to_csr(DIA(d.data.bfloat16(), d.offsets, d.shape))
    with pytest.raises(ValueError, match="offsets"):
        dia_convert.dia_to_csr(DIA(d.data[:2], d.offsets, d.shape))
    assert dia_convert.dia_to_csr.launches == before + 1
