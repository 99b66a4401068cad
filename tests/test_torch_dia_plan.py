"""K3's launch plan (``ops/dia_kernels.launch_plan``), walked on the CPU
block by block as ``csrc/dia_spgemm_fused.cu`` runs it: each block stages
its group's rows into a shared-memory array (every other slot NaN, so a
read the plan did not stage shows), then adds each plane's terms from it,
starting from -0.0. The result must equal the gather form, K3's plain
version, bit for bit (numpy rounds each float32 / float64 multiply and add
as the kernel's __fmul_rn / __fadd_rn do). Also: the plan's limits and
caching, and that CPU planes keep the gather form."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu_torch.ops import dia as tdia
from benchmark_spgemm_using_csr_tpu_torch.ops import dia_kernels
from benchmark_spgemm_using_csr_tpu_torch.sparse.dia import DIA
from benchmark_spgemm_using_csr_tpu_torch.utils import generators as gen

torch.set_num_threads(2)


def walk_plan(plan, a: np.ndarray, b: np.ndarray, k: int, n: int):
    """C's planes as the kernel computes them from ``plan``."""
    dtype = a.dtype
    size = dtype.itemsize
    out = np.full((len(plan.plane_terms), n), np.nan, dtype)
    jl = np.arange(plan.tile)
    for p0, count, row0, nb, na, term0, nterms, terms_at in plan.groups:
        for t in range(plan.ntiles):
            j0 = t * plan.tile
            cols = j0 + jl
            keep = cols < n
            if not plan.staged:  # the direct mode reads the planes
                for p in range(p0, p0 + count):
                    _, _, start, end = plan.plane_terms[p]
                    acc = np.full(plan.tile, -0.0, dtype)
                    for s1, s2, d2, _ in plan.terms[start:end]:
                        ja = cols - d2
                        inside = (ja >= 0) & (ja < k) & keep
                        av = np.zeros(plan.tile, dtype)
                        av[inside] = a[s1, ja[inside]]
                        bv = np.zeros(plan.tile, dtype)
                        bv[keep] = b[s2, cols[keep]]
                        acc = acc + av * bv
                    out[p, cols[keep]] = acc[keep]
                continue
            assert terms_at % 16 == 0
            assert terms_at + 16 * nterms + 16 * -(-count // 3) <= plan.smem
            stage = np.full(terms_at // size, np.nan, dtype)
            for r in range(nb + na):
                slot, shift, width, at = plan.rows[row0 + r]
                src, length = (b, n) if r < nb else (a, k)
                win = j0 - shift + np.arange(width)
                inside = (win >= 0) & (win < length)
                assert (at + width) * size <= terms_at
                assert (shift * size) % 16 == (width * size) % 16 == 0
                assert (at * size) % 16 == 0
                stage[at:at + width] = 0
                stage[at:at + width][inside] = src[slot, win[inside]]
            table = plan.terms[term0:term0 + nterms]
            q_max = dia_kernels.PLANES_PER_ITEM
            items = plan.plane_terms[p0:p0 + -(-count // q_max)]
            assert sorted(i for i, _, _, _ in items) == list(
                range(0, count, q_max))
            for first, planes_here, start, end in items:
                assert planes_here == min(q_max, count - first)
                acc = np.full((q_max, plan.tile), -0.0, dtype)
                for bo, *aos in table[start:end]:
                    assert bo % size == 0
                    bv = stage[bo // size + jl]
                    for q, ao in enumerate(aos):
                        assert ao == -1 or (ao % size == 0 and q < planes_here)
                        if ao >= 0:
                            acc[q] = acc[q] + stage[ao // size + jl] * bv
                for q in range(planes_here):
                    out[p0 + first + q, cols[keep]] = acc[q][keep]
    return out


def k3_walk(a: DIA, b: DIA, tiles=dia_kernels.TILES) -> DIA:
    """The K3 wrapper's path with the kernel replaced by ``walk_plan``,
    the plan's tile chosen among ``tiles``."""
    prep = dia_kernels._prepare(a, b, 4096)
    if prep is None:
        return dia_kernels._zero(a, b)
    dtype, off_c = prep
    an = a.data.to(dtype).numpy()
    bn = b.data.to(dtype).numpy()
    plan = dia_kernels._plan(tuple(a.offsets), tuple(b.offsets), b.n,
                             an.itemsize, tiles, dia_kernels.SMEM_BUDGET)
    return DIA(torch.from_numpy(walk_plan(plan, an, bn, a.n, b.n)), off_c,
               (a.m, b.n))


def rect_pair():
    rng = np.random.default_rng(0)
    a = sp.diags([rng.standard_normal(40), rng.standard_normal(40)],
                 [0, 3], shape=(40, 43), format="csr").astype(np.float32)
    b = sp.diags([rng.standard_normal(40), rng.standard_normal(43)],
                 [-3, 2], shape=(43, 50), format="csr").astype(np.float32)
    return a, b


def planes(n, offsets, seed, m=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    return DIA.from_numpy(data, sorted(offsets), (m or n, n), device="cpu")


def scipy_pair(a_sp, b_sp=None):
    b_sp = a_sp if b_sp is None else b_sp
    return (DIA.from_scipy(a_sp, device="cpu"),
            DIA.from_scipy(b_sp, device="cpu"))


CASES = {
    "poisson2d_16": lambda: scipy_pair(gen.poisson2d(16)),
    "stencil27_6": lambda: scipy_pair(gen.stencil27(6)),
    "fem_4_dof3": lambda: scipy_pair(gen.fem(4, dof=3, fill=0.9, seed=5)),
    "rectangular": lambda: scipy_pair(*rect_pair()),
    "ragged_n_below_tile": lambda: (planes(100, (-7, 0, 2), 1),) * 2,
    "n_one_past_tiles": lambda: (planes(4 * 256 + 1, (-40, -3, 0, 5), 2),
                                 planes(4 * 256 + 1, (-1, 0, 1, 33), 3)),
    "float64": lambda: (planes(700, (-9, 0, 4), 4, dtype=np.float64),
                        planes(700, (-2, 0, 11), 5, dtype=np.float64)),
    "span_4096": lambda: (planes(5000, (-2048, -1, 0, 1, 2048), 6),) * 2,
    "wide_cluster": lambda: (planes(300, range(-32, 33, 2), 7),) * 2,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_walk_is_bit_equal_to_the_gather_form(name):
    a, b = CASES[name]()
    want = tdia.dia_spgemm(a, b, fused=False)
    got = k3_walk(a, b)
    assert got.offsets == want.offsets and got.shape == want.shape
    assert got.dtype == want.dtype
    assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("tile", dia_kernels.TILES)
def test_every_tile_width_is_bit_equal(tile):
    a, b = CASES["stencil27_6"]()
    want = tdia.dia_spgemm(a, b, fused=False)
    plan = dia_kernels._plan(tuple(a.offsets), tuple(b.offsets), b.n, 4,
                             (tile,), dia_kernels.SMEM_BUDGET)
    assert plan.staged and plan.tile == tile
    assert torch.equal(k3_walk(a, b, (tile,)).data, want.data)


@pytest.mark.parametrize("tile", [128, 256])
def test_n_below_one_tile_is_bit_equal(tile):
    a, b = CASES["ragged_n_below_tile"]()
    plan = dia_kernels._plan(tuple(a.offsets), tuple(b.offsets), b.n, 4,
                             (tile,), dia_kernels.SMEM_BUDGET)
    assert plan.ntiles == 1 and b.n < plan.tile
    want = tdia.dia_spgemm(a, b, fused=False)
    assert torch.equal(k3_walk(a, b, (tile,)).data, want.data)


def test_direct_mode_is_bit_equal():
    """A budget no plane fits below SMEM_MAX still stages; the direct mode
    is taken where even SMEM_MAX is too small (here: a 300-diagonal band
    in float64)."""
    a = planes(600, range(-150, 150), 8, dtype=np.float64)
    plan = dia_kernels.launch_plan(tuple(a.offsets), tuple(a.offsets), a.n,
                                   8)
    assert not plan.staged and plan.smem == 0
    # each of the direct block's 8 warps gets 32 * lanes of the columns
    assert plan.tile == 8 * 32 * plan.lanes
    want = tdia.dia_spgemm(a, a, fused=False)
    assert torch.equal(k3_walk(a, a).data, want.data)


def test_empty_operand_gives_one_zero_plane():
    a = planes(64, (-1, 0, 1), 9)
    empty = DIA(torch.zeros((0, 64)), (), (64, 64))
    for x, y in ((a, empty), (empty, a)):
        c = k3_walk(x, y)
        assert c.offsets == (0,) and c.data.shape == (1, 64)
        assert not c.data.any()


def test_plan_fits_shared_memory_and_fills_the_card():
    """The suite's 99-diagonal FEM planes and stencil27's: every block
    within the budget, enough blocks for 132 SMs, and each group's staged
    rows the rows its terms read."""
    for a_sp in (gen.fem(8, dof=3, fill=0.9, seed=5), gen.stencil27(16)):
        a = DIA.from_scipy(a_sp, device="cpu")
        off = tuple(a.offsets)
        plan = dia_kernels.launch_plan(off, off, a.n, 4)
        assert plan.staged and plan.smem <= dia_kernels.SMEM_BUDGET
        assert len(plan.groups) * plan.ntiles >= dia_kernels.TARGET_BLOCKS
        assert plan.groups[:, 1].sum() == len(plan.plane_terms)


def test_clusters_split_at_gaps_and_widths():
    assert dia_kernels.b_clusters((-724, -1, 0, 1, 724)) == [
        (0, 1), (1, 4), (4, 5)]
    assert dia_kernels.b_clusters(tuple(range(0, 200, 10))) == [
        (0, 7), (7, 14), (14, 20)]
    assert dia_kernels.b_clusters(()) == []


def test_plan_terms_runs_once_per_offset_pair(monkeypatch):
    calls = []
    real = dia_kernels.plan_terms

    def counted(off_a, off_b):
        calls.append((off_a, off_b))
        return real(off_a, off_b)

    monkeypatch.setattr(dia_kernels, "plan_terms", counted)
    dia_kernels._term_plan.cache_clear()
    dia_kernels.launch_plan.cache_clear()
    a = planes(300, (-17, -1, 0, 1, 17), 10)
    for _ in range(3):
        dia_kernels.dia_spgemm_fused(a, a)
        dia_kernels.dia_spgemm_fused_plain(a, a)
        tdia.dia_spgemm(a, a)
        dia_kernels.launch_plan(tuple(a.offsets), tuple(a.offsets), a.n, 4)
    assert len(calls) == 1
    dia_kernels._term_plan.cache_clear()
    dia_kernels.launch_plan.cache_clear()


def test_auto_gate_keeps_the_gather_form_on_cpu_for_27_diagonals():
    a = DIA.from_scipy(gen.stencil27(8), device="cpu")
    before = dia_kernels.dia_spgemm_fused.launches
    c = tdia.dia_spgemm(a, a)
    assert dia_kernels.dia_spgemm_fused.launches == before
    assert torch.equal(c.data, tdia.dia_spgemm(a, a, fused=False).data)


def test_plan_rejects_a_tile_off_the_list():
    with pytest.raises(ValueError, match="tile"):
        dia_kernels._plan((0,), (0,), 100, 4, (96,), dia_kernels.SMEM_BUDGET)
