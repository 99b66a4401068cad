"""The yardstick's inputs and arithmetic: the frozen generators and roofline
against the program's originals, the seeded values and the permutation."""
import numpy as np
import pytest
import torch

from spgemm_bench import inputs, roofline
from spgemm_bench.generators import circuit, poisson2d
from spgemm_bench.reference import sparse


def _scipy(rowptr, colidx, vals, shape):
    import scipy.sparse as sp

    return sp.csr_matrix((vals, colidx, rowptr), shape=shape)


@pytest.mark.parametrize("gen, params, original", [
    (circuit, {"n": 4096, "seed": 3}, ("circuit", (4096,), {"seed": 3})),
    (poisson2d, {"k": 40}, ("poisson2d", (40,), {})),
])
def test_frozen_generators_equal_the_programs(gen, params, original):
    from benchmark_spgemm_using_csr_tpu_torch.utils import generators

    name, args, kwargs = original
    want = getattr(generators, name)(*args, **kwargs)
    rowptr, colidx, vals, shape = gen.generate(**params)
    assert shape == want.shape
    np.testing.assert_array_equal(rowptr, want.indptr)
    np.testing.assert_array_equal(colidx, want.indices)
    np.testing.assert_array_equal(vals, want.data)


def test_frozen_bound_agrees_with_its_arithmetic_and_the_programs():
    from benchmark_spgemm_using_csr_tpu_torch.utils import roofline as prog

    m, k, nnz_a, nnz_b, nnz_c, products = 1000, 800, 5000, 4000, 9000, 30000
    b = roofline.csr_product_bound(m, k, nnz_a, nnz_b, nnz_c, products)
    by_hand = ((m + 1) * 4 + nnz_a * 8) + ((k + 1) * 4 + nnz_b * 8) \
        + ((m + 1) * 4 + nnz_c * 8)
    assert b.bytes_moved == by_hand and b.flops == 2 * products
    want = prog.csr_product_bound(m, k, nnz_a, nnz_b, nnz_c, products)
    assert b.bytes_moved == want.bytes_moved and b.flops == want.flops
    assert b.least_s() == pytest.approx(want.sol_time_s(prog.H100_SXM))
    assert roofline.HBM_BYTES_PER_S == prog.H100_SXM.hbm_bytes_per_s
    assert roofline.F32_FLOPS == prog.H100_SXM.f32_flops
    assert (b + b).flops == 2 * b.flops


def test_value_sets_repeat_by_seed_and_keep_signs():
    base = torch.tensor([4.0, -1.0, 2.5, -0.5])
    big = 2**31 + 12345
    a = inputs.value_sets(base, 3, 0.5, big)
    assert torch.equal(a, inputs.value_sets(base, 3, 0.5, big))
    assert not torch.equal(a, inputs.value_sets(base, 3, 0.5, big + 1))
    assert torch.equal(torch.sign(a), torch.sign(base).expand(3, -1))
    ratio = a / base
    assert float(ratio.min()) >= 0.5 and float(ratio.max()) <= 1.5
    assert not torch.equal(a[0], a[1])


def test_stream_seed_takes_any_whole_seed():
    seeds = {inputs.stream_seed(s, 1) for s in (0, 1, -1, 2**31 + 5, 2**40)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)


def test_permutation_keeps_products_nnz_c_and_row_lengths():
    rowptr, colidx, vals, shape = circuit.generate(n=1024, seed=2)
    n = shape[0]
    rp = torch.from_numpy(rowptr.astype(np.int64))
    ci = torch.from_numpy(colidx.astype(np.int64))
    v = torch.from_numpy(vals)
    a = sparse.from_arrays(rp, ci, v, shape, "cpu")
    c, products = sparse.spgemm(a, a)
    p_ptr, p_col, p_val = inputs.permute(rp, ci, v, n, 99, 4)
    pa = sparse.from_arrays(p_ptr, p_col, p_val, shape, "cpu")
    pc, p_products = sparse.spgemm(pa, pa)
    assert p_products == products and pc.nnz == c.nnz
    assert sorted(np.diff(p_ptr.numpy())) == sorted(np.diff(rowptr))
    # the same (seed, index) gives the same matrix; another index another
    again = inputs.permute(rp, ci, v, n, 99, 4)
    assert all(torch.equal(x, y) for x, y in zip(again, (p_ptr, p_col,
                                                         p_val)))
    assert not torch.equal(inputs.permute(rp, ci, v, n, 99, 5)[1], p_col)
    # P A P^T: the permuted product is the product permuted
    g = inputs.generator(99, inputs.PERMUTATION, "cpu", 4)
    perm = torch.randperm(n, generator=g).numpy()
    want = _scipy(rowptr, colidx, vals, shape)
    pm = np.zeros((n, n))
    pm[perm, np.arange(n)] = 1
    import scipy.sparse as sp

    pm = sp.csr_matrix(pm)
    np.testing.assert_allclose(
        _scipy(p_ptr.numpy(), p_col.numpy(), p_val.numpy(), shape).toarray(),
        (pm @ want @ pm.T).toarray())
