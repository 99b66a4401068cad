"""The PyTorch port's tiled and binned paths (ops/tiled.py, ops/binned.py,
csr_gather_rows) against the reference package on the same inputs.

On the CPU, kernel K2 runs its plain version; the reference runs its
Pallas kernel in interpret mode (tiled, binned "pallas") or XLA's lane
sort (binned "xla"). The port's binned path has the one form, K2: it is
held against both of the reference's backends. Structures (rowptr, colidx, padding) compare exactly;
values at the scipy oracle's default tolerance, rtol 1e-5 / atol 1e-6
(float32 sums of a few products in another order)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.ops import binned as jbinned
from benchmark_spgemm_using_csr_tpu.ops import tiled as jtiled
from benchmark_spgemm_using_csr_tpu.sparse.csr import (
    csr_gather_rows as j_gather_rows,
)
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen
from benchmark_spgemm_using_csr_tpu.utils.oracle import random_csr

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import binned as tbinned
from benchmark_spgemm_using_csr_tpu_torch.ops import kernels
from benchmark_spgemm_using_csr_tpu_torch.ops import tiled as ttiled
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def same_csr(got, want, **tol):
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **(tol or TOL))


# ---- tiled ----------------------------------------------------------------

TILED = {
    "poisson2d_24": lambda: (jgen.poisson2d(24),) * 2,  # W = 32
    "banded": lambda: (jgen.banded(256, bandwidth=2, seed=3),) * 2,
    "wide_band": lambda: (jgen.banded(300, bandwidth=7, seed=5),) * 2,
    "rectangular": lambda: (random_csr(96, 64, density=0.1, seed=5)
                            .to_scipy(),
                            random_csr(64, 120, density=0.1, seed=6)
                            .to_scipy()),  # W = 256
}


@pytest.mark.parametrize("name", sorted(TILED))
def test_tiled_same_csr_as_reference(name):
    a_sp, b_sp = TILED[name]()
    ja, jb = J.CSR.from_scipy(a_sp), J.CSR.from_scipy(b_sp)
    jplan = jtiled.make_tiled_plan(ja, jb)
    tplan = ttiled.make_tiled_plan(bridge(ja), bridge(jb))
    assert jplan is not None and tplan is not None
    assert (tplan.width, tplan.prod_cap, tplan.out_cap) == (
        jplan.width, jplan.prod_cap, jplan.out_cap)
    want = jtiled.spgemm_tiled(ja, jb, jplan)
    before = kernels.bin_sort_compress.launches
    got = ttiled.spgemm_tiled(bridge(ja), bridge(jb), tplan)
    assert kernels.bin_sort_compress.launches == before  # CPU: plain
    same_csr(got, want)
    assert_csr_equal(got, spgemm_reference(bridge(ja), bridge(jb)), **TOL)


def test_tiled_expand_rows_is_the_reference_tile():
    """The tile K2 sorts: row i holds row i's products, sentinel n on the
    dead lanes; as multisets of (col, val) per row it is the reference's."""
    a_sp = jgen.poisson2d(6)
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    plan = ttiled.make_tiled_plan(ta, ta)
    col, val = ttiled.expand_rows(ta, ta, plan)
    assert col.shape == (ta.m, plan.width) and col.dtype == torch.int32
    assert val.dtype == torch.float32
    lens = np.diff(a_sp.indptr)
    dense = a_sp.toarray()
    for i in range(ta.m):
        live = col[i] < ta.n
        nnz_ct = int(lens[a_sp.indices[a_sp.indptr[i]:a_sp.indptr[i + 1]]]
                     .sum())
        assert int(live.sum()) == nnz_ct
        assert (val[i][~live] == 0).all()
        row = np.zeros(ta.n, np.float64)
        np.add.at(row, col[i][live].numpy(), val[i][live].numpy())
        np.testing.assert_allclose(row, dense[i] @ dense, rtol=1e-5,
                                   atol=1e-6)


def test_tiled_regime_rejections():
    pl = J.CSR.from_scipy(jgen.power_law(256, 256, alpha=1.8, max_deg=128,
                                         seed=1))
    assert jtiled.make_tiled_plan(pl, pl, max_width=64) is None
    assert ttiled.make_tiled_plan(bridge(pl), bridge(pl), max_width=64) is None
    z = T.CSR.from_scipy(sp.csr_matrix((16, 16), dtype=np.float32),
                         device="cpu")
    assert ttiled.make_tiled_plan(z, z) is None
    # a thin tile: one long row among empty ones (fill < 30%)
    thin = np.diag(np.ones(64, np.float32))
    thin[0, :] = 1.0
    t = T.CSR.from_scipy(sp.csr_matrix(thin), device="cpu")
    assert ttiled.make_tiled_plan(t, t) is None


def test_facade_tiled():
    ja = J.CSR.from_scipy(jgen.poisson2d(20))
    same_csr(T.spgemm(bridge(ja), bridge(ja), method="tiled"),
             J.spgemm(ja, ja, method="tiled"), rtol=1e-4, atol=1e-5)
    pl = T.CSR.from_scipy(jgen.power_law(256, 256, alpha=1.8, max_deg=128,
                                         seed=1), device="cpu")
    with pytest.raises(ValueError, match="tiled regime"):
        T.spgemm(pl, pl, method="tiled")


# ---- binned -----------------------------------------------------------------

BINNED = {
    "er": lambda: jgen.erdos_renyi(200, 200, 5.0, seed=7),
    "poisson2d": lambda: jgen.poisson2d(16),
    "powerlaw": lambda: jgen.power_law(200, 200, alpha=1.9, max_deg=96,
                                       seed=8),
    # rows past the last width (512 products) take the ESC tail
    "powerlaw_tail": lambda: jgen.power_law(600, 600, alpha=1.9,
                                            max_deg=300, seed=8),
}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(BINNED))
def test_binned_same_csr_as_reference(name, backend):
    ja = J.CSR.from_scipy(BINNED[name]())
    cap = J.pad_bucket(J.spgemm_flops(ja, ja) // 2)
    want = jbinned.spgemm_binned_host(ja, ja, prod_capacity=cap,
                                      backend=backend)
    before = kernels.bin_sort_compress.launches
    got = tbinned.spgemm_binned_host(bridge(ja), bridge(ja),
                                     prod_capacity=cap)
    assert kernels.bin_sort_compress.launches == before  # CPU: plain
    same_csr(got, want)
    assert_csr_equal(got, spgemm_reference(bridge(ja), bridge(ja)), **TOL)


def test_binned_tail_rows_exist():
    ta = T.CSR.from_scipy(BINNED["powerlaw_tail"](), device="cpu")
    nnz_ct = T.nnz_upper_bound(ta, ta).numpy()
    bins, tail = tbinned.make_plan(nnz_ct)
    assert tail.size > 0 and set(bins) == {8, 32, 128, 512}


@pytest.mark.parametrize("widths", [(8, 32, 128, 512), (4, 16), (64,)])
def test_make_plan_matches_reference(widths):
    a = T.CSR.from_scipy(BINNED["powerlaw_tail"](), device="cpu")
    nnz_ct = T.nnz_upper_bound(a, a).numpy()
    want_bins, want_tail = jbinned.make_plan(nnz_ct, widths)
    got_bins, got_tail = tbinned.make_plan(nnz_ct, widths)
    assert list(got_bins) == list(want_bins)
    for w in want_bins:
        np.testing.assert_array_equal(got_bins[w], want_bins[w])
    np.testing.assert_array_equal(got_tail, want_tail)


def test_binned_rectangular_and_float64():
    sa, sb = jgen.rect_pair(300, 150, 250, seed=7)
    ta = T.CSR.from_scipy(sa, device="cpu")
    tb = T.CSR.from_scipy(sb, device="cpu")
    cap = T.pad_bucket(T.spgemm_flops(ta, tb) // 2)
    c = tbinned.spgemm_binned_host(ta, tb, prod_capacity=cap)
    assert_csr_equal(c, spgemm_reference(ta, tb), **TOL)
    a64 = T.CSR.from_scipy(BINNED["powerlaw_tail"](), dtype=np.float64,
                           device="cpu")
    c = tbinned.spgemm_binned_host(
        a64, a64, prod_capacity=T.pad_bucket(T.spgemm_flops(a64, a64) // 2))
    assert c.vals.dtype == torch.float64
    assert_csr_equal(c, spgemm_reference(a64, a64), rtol=1e-12, atol=1e-12)


def test_facade_binned():
    ja = J.CSR.from_scipy(BINNED["powerlaw_tail"]())
    same_csr(T.spgemm(bridge(ja), bridge(ja), method="binned"),
             J.spgemm(ja, ja, method="binned"), rtol=1e-4, atol=1e-5)
    z = T.CSR.from_scipy(sp.csr_matrix((16, 16), dtype=np.float32),
                         device="cpu")
    assert int(T.spgemm(z, z, method="binned").rowptr[-1]) == 0


# ---- csr_gather_rows ----------------------------------------------------------


@pytest.mark.parametrize("rows", [
    [3, 0, 7, 7, 2],
    [5, 1, 64, 64, 64],  # padded with the sentinel a.m
    [9, 4],  # row 9 is empty
    [],
])
def test_csr_gather_rows_matches_reference(rows):
    import jax.numpy as jnp

    mat = sp.random(64, 40, density=0.08, format="lil", random_state=3,
                    dtype=np.float32)
    mat[9, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    ja = J.CSR.from_scipy(mat)
    cap = 64
    r = np.asarray(rows, np.int32)
    got = T.csr_gather_rows(bridge(ja), torch.from_numpy(r), cap)
    assert got.shape == (len(rows), 40) and got.capacity == cap
    if rows:
        want = j_gather_rows(ja, jnp.asarray(r), cap)
        same_csr(got, want, rtol=0, atol=0)
    else:
        assert got.rowptr.tolist() == [0] and not got.colidx.any()
