"""The PyTorch port's containers and copied numpy modules against the
reference package: buffers, generators and Matrix Market I/O must agree
bit for bit (integer buffers exactly; values exactly, since nothing is
computed)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.sparse import csr as jcsr
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen
from benchmark_spgemm_using_csr_tpu.utils import mtx as jmtx

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.sparse import csr as tcsr
from benchmark_spgemm_using_csr_tpu_torch.utils import generators as tgen
from benchmark_spgemm_using_csr_tpu_torch.utils import mtx as tmtx
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import assert_csr_equal

torch.set_num_threads(2)


def bridge(j):
    """The reference package's CSR as the port's, through numpy."""
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def assert_same_buffers(j, t):
    assert tuple(t.shape) == tuple(j.shape)
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(t.rowptr.numpy(), np.asarray(j.rowptr))
    np.testing.assert_array_equal(t.colidx.numpy(), np.asarray(j.colidx))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))


# cheap members of the suite (the 1M-row ones are covered at small size
# through their generator functions below)
CHEAP_SUITE = ["poisson2d_64", "banded_16k", "er_small", "powerlaw_small",
               "stencil27_32", "dense_rows_2k", "pdb_8k", "femirr_17k"]


def test_suite_has_the_same_members():
    assert sorted(tgen.SUITE) == sorted(jgen.SUITE)
    assert sorted(tgen.SUITE_PAIRS) == sorted(jgen.SUITE_PAIRS)


@pytest.mark.parametrize("name", CHEAP_SUITE)
def test_suite_matrix_identical(name):
    """SUITE[name]() gives the same matrix bit for bit in both packages."""
    t, j = tgen.SUITE[name](), jgen.SUITE[name]()
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.data, j.data)
    assert t.dtype == j.dtype


@pytest.mark.parametrize("make", [
    lambda g: g.circuit(1024, seed=3),
    lambda g: g.road_net(32, seed=13),
    lambda g: g.small_world(1000, k=4, seed=14),
    lambda g: g.hub_rows(512, 512, max_deg=128, n_hubs=4, seed=1),
    lambda g: g.fem_irregular(5, dof=3, seed=3),
    lambda g: g.rect_pair(300, 200, 100, seed=7)[1],
], ids=["circuit", "road_net", "small_world", "hub_rows", "fem_irregular",
        "rect_pair"])
def test_generators_identical(make):
    t, j = make(tgen), make(jgen)
    assert (t != j).nnz == 0 and t.shape == j.shape
    np.testing.assert_array_equal(t.indices, j.indices)


@pytest.mark.parametrize("name", ["er_small", "powerlaw_small"])
def test_from_numpy_bridge_keeps_buffers(name):
    j = J.CSR.from_scipy(jgen.SUITE[name]())
    assert_same_buffers(j, bridge(j))


@pytest.mark.parametrize("capacity", [None, 40000])
def test_from_scipy_same_padding(capacity):
    a = jgen.SUITE["er_small"]()
    j = J.CSR.from_scipy(a, capacity=capacity)
    t = T.CSR.from_scipy(a, capacity=capacity, device="cpu")
    assert_same_buffers(j, t)
    r, c, v = t.to_numpy()
    np.testing.assert_array_equal(r, np.asarray(j.rowptr))
    assert t.device.type == "cpu" and t.dtype == torch.float32


def test_pad_bucket_and_pad_gentle_match():
    from benchmark_spgemm_using_csr_tpu.ops.chunked import pad_gentle as jpg
    from benchmark_spgemm_using_csr_tpu_torch.ops.stream import pad_gentle

    for n in [0, 1, 7, 8, 9, 100, 1023, 1024, 1025, 12345, 1 << 27]:
        assert tcsr.pad_bucket(n) == jcsr.pad_bucket(n)
        assert pad_gentle(n) == jpg(n)


def test_row_ids_coo_transpose_match():
    rng = np.random.default_rng(5)
    a_sp = sp.random(60, 45, density=0.1, random_state=rng, format="csr",
                     dtype=np.float32)
    a_sp[10:20, :] = 0  # empty rows
    a_sp.eliminate_zeros()
    j = J.CSR.from_scipy(a_sp)
    t = bridge(j)
    np.testing.assert_array_equal(t.row_ids().numpy(), np.asarray(j.row_ids()))
    assert_same_buffers(J.csr_transpose(j), T.csr_transpose(t))
    # COO with duplicates + padding, summed
    row = rng.integers(0, 30, 200)
    col = rng.integers(0, 20, 200)
    val = rng.standard_normal(200).astype(np.float32)
    jc = jcsr.COO.from_arrays(row, col, val, (30, 20)).to_csr(
        sum_duplicates=True)
    tc = tcsr.COO.from_arrays(row, col, val, (30, 20), device="cpu").to_csr(
        sum_duplicates=True)
    np.testing.assert_array_equal(tc.rowptr.numpy(), np.asarray(jc.rowptr))
    nnz = int(tc.rowptr[-1])
    np.testing.assert_array_equal(tc.colidx.numpy()[:nnz],
                                  np.asarray(jc.colidx)[:nnz])
    # duplicate sums in another order: float32 tolerance
    np.testing.assert_allclose(tc.vals.numpy()[:nnz],
                               np.asarray(jc.vals)[:nnz], rtol=1e-6, atol=1e-6)


def test_with_capacity_and_validate():
    t = T.CSR.from_scipy(jgen.SUITE["er_small"](), device="cpu")
    nnz = int(t.rowptr[-1])
    s = t.with_capacity(nnz)
    assert s.capacity == nnz
    assert_csr_equal(s, t.to_scipy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="capacity"):
        t.with_capacity(nnz - 1)
    bad = T.CSR(t.rowptr, torch.where(torch.arange(t.capacity) == 3,
                                      10**6, t.colidx).to(torch.int32),
                t.vals, t.shape)
    with pytest.raises(ValueError, match="out of range"):
        bad.validate()
    assert t.validate() is t


def test_oracle_catches_a_wrong_value():
    t = T.CSR.from_scipy(jgen.SUITE["er_small"](), device="cpu")
    want = t.to_scipy()
    want.data[5] += 1.0
    with pytest.raises(AssertionError, match="value"):
        assert_csr_equal(t, want)


@pytest.mark.parametrize("field", ["real", "pattern"])
def test_mtx_roundtrip_matches_reference(tmp_path, field):
    a = jgen.power_law(300, 300, alpha=1.9, max_deg=60, seed=42)
    path = str(tmp_path / "m.mtx")
    if field == "pattern":
        jgen.write_pattern_mtx(path, m=512, seed=3)
    else:
        tmtx.write_mtx(path, a)
    t, j = tmtx.read_mtx(path), jmtx.read_mtx(path)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.data, j.data)
    # the numpy path reads the same matrix as the native one
    u = tmtx._read_mtx_numpy(path)
    assert (u != t).nnz == 0


@pytest.mark.parametrize("size,high", [(0, 1), (1, 5), (1000, 10),
                                       (5000, 1 << 40)])
def test_sorted_unique_is_np_unique(size, high):
    x = np.random.default_rng(size).integers(-high, high, size=size)
    got = tcsr.sorted_unique(x)
    want = np.unique(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_host_mirror_holds_tensors_weakly():
    """The mirror keeps a weak reference: an entry leaves it when its
    tensor is collected, so a tensor with a recycled id() never finds the
    old entry. Meta tensors stand in for device tensors here (the memo
    serves every tensor off the CPU)."""
    import gc

    tcsr.clear_host_mirror()
    x = torch.empty(16, device="meta")
    host = np.arange(16)
    tcsr._remember_host(x, host)
    assert tcsr.host_view(x) is host
    assert len(tcsr._HOST_MIRROR) == 1
    del x
    gc.collect()
    assert len(tcsr._HOST_MIRROR) == 0


def test_bfloat16_host_view_is_float32():
    x = torch.tensor([1.0, 1.0 / 3.0, -2.5e-3], dtype=torch.bfloat16)
    got = tcsr.host_view(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())
