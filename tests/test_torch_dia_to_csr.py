"""DIA -> CSR (``ops/dia_convert``, kernel K4's plain version and the
capacity rule) on the CPU.

The conversion copies values and sums nothing, so every comparison is
exact: rowptr, colidx[:nnz] and vals[:nnz] bit for bit, zero past nnz, at
the capacity ``pad_bucket`` of the planes' in-matrix slot count. The
yardsticks are the reference package's ``DIA.to_csr`` (scipy's, float32,
pruned) and a row-major walk of the slots in numpy. The kernel itself is
held against the plain version on the card (``tests/test_torch_kernels.py``,
marked ``cuda``).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu.sparse.dia import DIA as JDIA

from benchmark_spgemm_using_csr_tpu_torch.ops import dia_convert
from benchmark_spgemm_using_csr_tpu_torch.ops.dia import dia_spgemm
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR, pad_bucket
from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import DIA
from benchmark_spgemm_using_csr_tpu_torch.utils import generators

torch.set_num_threads(2)


def squared(mat) -> DIA:
    """The planes of C = A @ A, as the dia path hands them to ``to_csr``."""
    a = DIA.from_csr(CSR.from_scipy(mat, device="cpu"), device="cpu")
    return dia_spgemm(a, a)


def rect_product() -> DIA:
    rng = np.random.default_rng(0)
    a = sp.diags([rng.standard_normal(40), rng.standard_normal(40)], [0, 3],
                 shape=(40, 43)).astype(np.float32)
    b = sp.diags([rng.standard_normal(40), rng.standard_normal(43)], [-3, 2],
                 shape=(43, 50)).astype(np.float32)
    return dia_spgemm(DIA.from_scipy(a, device="cpu"),
                      DIA.from_scipy(b, device="cpu"))


def planes(n, offsets, seed, m=None, dtype=np.float32, zero=0.0) -> DIA:
    """Random planes; ``zero`` of the slots exactly 0."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    data[rng.random(data.shape) < zero] = 0
    return DIA.from_numpy(data, offsets, (m or n, n), device="cpu")


def zero_plane() -> DIA:
    d = planes(300, (-5, -1, 0, 2, 7), 1)
    d.data[2] = 0
    return d


def rows_all_pruned() -> DIA:
    """Rows 0, 17, 18 and 299 hold only exact zeros (-0.0 among them)."""
    d = planes(300, (-5, -1, 0, 2, 7), 2)
    for r in (0, 17, 18, 299):
        for s, off in enumerate(d.offsets):
            if 0 <= r + off < d.n:
                d.data[s, r + off] = -0.0 if s % 2 else 0.0
    return d


CASES = {
    "poisson2d_24": lambda: squared(generators.poisson2d(24)),
    "poisson2d_256": lambda: squared(generators.poisson2d(256)),
    "stencil27_32": lambda: squared(generators.stencil27(32)),
    "fem": lambda: DIA.from_scipy(generators.fem(6, dof=3, fill=0.9, seed=5),
                                  device="cpu"),
    "rectangular": rect_product,
    "tall": lambda: planes(90, (-100, -3, 0, 4), 3, m=200, zero=0.2),
    "wide": lambda: planes(333, (-2, 0, 150, 332, 400), 4, m=100, zero=0.2),
    "zero_plane": zero_plane,
    "rows_all_pruned": rows_all_pruned,
    "float64": lambda: planes(1000, (-31, -1, 0, 1, 31), 5, dtype=np.float64,
                              zero=0.3),
}


def walk(d: DIA, prune: bool):
    """numpy: each row's slots in ascending offset, kept where in the
    matrix (and != 0 with ``prune``). Returns (rowptr, colidx, vals)."""
    data = d.data.numpy()
    offs = np.asarray(d.offsets, np.int64)
    col = np.arange(d.m)[:, None] + offs[None, :]
    inside = (col >= 0) & (col < d.n)
    val = data[np.arange(d.ndiag)[None, :], np.clip(col, 0, d.n - 1)]
    keep = inside & (val != 0) if prune else inside
    rowptr = np.concatenate([[0], np.cumsum(keep.sum(1))])
    return rowptr, col[keep], val[keep]


def bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int64 if x.itemsize == 8 else np.int32)


def assert_csr(got, rowptr, colidx, vals, d: DIA):
    nnz = int(rowptr[-1])
    assert got.rowptr.dtype == got.colidx.dtype == torch.int32
    assert got.vals.dtype == d.dtype
    np.testing.assert_array_equal(got.rowptr.numpy(), rowptr)
    np.testing.assert_array_equal(got.colidx[:nnz].numpy(), colidx)
    got_vals = got.vals.numpy()
    np.testing.assert_array_equal(bits(got_vals[:nnz]),
                                  bits(np.asarray(vals, got_vals.dtype)))
    assert not got.colidx[nnz:].any() and not bits(got_vals[nnz:]).any()
    assert got.capacity == dia_convert.capacity(d.offsets, d.m, d.n)


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "keep"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_a_walk_of_the_slots(name, prune):
    d = CASES[name]()
    got = d.to_csr(prune=prune)
    assert_csr(got, *walk(d, prune), d)
    if not prune:  # every in-matrix slot: nnz is the slot count
        assert int(got.rowptr[-1]) == dia_convert.slot_count(d.offsets, d.m,
                                                             d.n)


@pytest.mark.parametrize("name", sorted(n for n in CASES if n != "float64"))
def test_plain_matches_the_reference_to_csr(name):
    d = CASES[name]()
    want = JDIA(d.data.numpy(), d.offsets, d.shape).to_csr(prune=True)
    nnz = int(want.rowptr[-1])
    assert_csr(d.to_csr(prune=True), np.asarray(want.rowptr),
               np.asarray(want.colidx)[:nnz], np.asarray(want.vals)[:nnz], d)


def test_no_diagonal_gives_an_empty_csr():
    d = DIA(torch.zeros((0, 7)), (), (5, 7))
    for prune in (True, False):
        got = d.to_csr(prune=prune)
        assert got.shape == (5, 7) and got.capacity == 8
        assert not got.rowptr.any() and not got.colidx.any()
        assert not got.vals.any()


@pytest.mark.parametrize("offsets,cap", [
    ((0,), 32),  # 32 slots: exactly a power of two
    ((0, 31), 64),  # 33 slots: the next bucket
    ((-31, 0), 64),
    ((32,), 8),  # no slot in the matrix
    ((-1, 0, 1), 128),  # 94 slots
])
def test_capacity_at_a_power_of_two_edge(offsets, cap):
    d = planes(32, offsets, 6)
    assert dia_convert.capacity(offsets, 32, 32) == cap
    for prune in (True, False):
        got = d.to_csr(prune=prune)
        assert got.capacity == cap
        assert_csr(got, *walk(d, prune), d)


def test_slot_count_is_the_valid_mask():
    for m, n, offsets in ((40, 43, (-50, -3, 0, 3, 42, 43)),
                          (100, 30, (-99, -70, 0, 29)), (1, 1, (0,))):
        d = DIA(torch.zeros((len(offsets), n)), offsets, (m, n))
        assert dia_convert.slot_count(offsets, m, n) == d.valid_mask().sum()


def test_the_cpu_runs_the_plain_version_and_launches_nothing():
    d = CASES["poisson2d_24"]()
    before = dia_convert.dia_to_csr.launches
    got = dia_convert.dia_to_csr(d, prune=True)
    want = dia_convert.dia_to_csr_plain(d, prune=True)
    assert dia_convert.dia_to_csr.launches == before
    for x, y in ((got.rowptr, want.rowptr), (got.colidx, want.colidx),
                 (got.vals, want.vals)):
        assert torch.equal(x, y)


def test_the_plan():
    offsets = (-725, -724, -723, -2, -1, 0, 1, 2, 723, 724, 725)
    p = dia_convert.plan(offsets, 1000, 1000, 4, torch.device("cpu"))
    assert p is dia_convert.plan(offsets, 1000, 1000, 4, torch.device("cpu"))
    assert p.offsets.dtype == torch.int32
    assert p.offsets.tolist() == list(offsets)
    assert p.cap == pad_bucket(dia_convert.slot_count(offsets, 1000, 1000))
    # a block of 256 rows stages its 256 * 11 slots in one pass
    assert (p.rows, p.blocks, p.window) == (256, 4, 256 * 11)
    # 125 planes: 32 rows a block, 8 chunks of 16 planes a row, one pass
    wide = dia_convert.plan(tuple(range(-62, 63)), 100, 100, 4,
                            torch.device("cpu"))
    assert (wide.rows, wide.blocks, wide.window) == (32, 4, 32 * 125)
    for itemsize in (4, 8):  # past the budget: several passes
        band = dia_convert.plan(tuple(range(-299, 300)), 9, 9, itemsize,
                                torch.device("cpu"))
        assert band.rows == 32 and band.blocks == 1
        assert band.window % 4 == 0 and band.window < 32 * 599
        assert (band.window + 4) * (4 + itemsize) <= dia_convert.SMEM_BUDGET
    with pytest.raises(ValueError, match="int32"):
        dia_convert.plan((0,), 2**31, 2**31, 4, torch.device("cpu"))


def test_other_devices_raise():
    d = DIA(torch.zeros((1, 4), device="meta"), (0,), (4, 4))
    with pytest.raises(ValueError, match="device"):
        dia_convert.dia_to_csr(d)
