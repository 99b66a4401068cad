"""The PyTorch port's ILU0 model (models/ilu0.py) against the reference
package on the same seeded inputs: the host plan's arrays equal, the
factor, its split and the Jacobi apply within float32 tolerance, and
preconditioned CG (Jacobi and exact applies) to within one iteration of
the reference with x within tolerance."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.models import ilu0 as jilu
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.models import ilu0 as tilu

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def tridiag(n=32):
    """The reference's test_ilu0_matches_exact_on_tridiag matrix."""
    return sp.diags([np.full(n, 4.0), np.full(n - 1, -1.0),
                     np.full(n - 1, -1.0)], [0, 1, -1],
                    format="csr").astype(np.float32)


def power_law_spd(n=400, seed=7):
    s = jgen.power_law(n, n, alpha=2.0, max_deg=48, seed=seed)
    s = abs((s + s.T).tocsr())
    deg = np.asarray(s.sum(axis=1)).ravel() + 1.0
    return (sp.diags(deg) - s).tocsr().astype(np.float32)


MATRICES = {
    "poisson2d_10": lambda: jgen.poisson2d(10).astype(np.float32),
    "tridiag_32": tridiag,
    "power_law_400": power_law_spd,
}


def both(a_sp, sweeps):
    ja = JCSR.from_scipy(a_sp)
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    return ja, ta, jilu.ilu0(ja, sweeps=sweeps), tilu.ilu0(ta, sweeps=sweeps)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ilu0_plan_arrays_equal_reference(name):
    a_sp = MATRICES[name]()
    got, want = tilu.ilu0_plan(a_sp), jilu.ilu0_plan(a_sp)
    for field in ("dep_l", "dep_u", "dep_mask", "diag_pos", "is_lower",
                  "row_of", "col_of"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ilu0_split_and_apply_equal_reference(name):
    import jax.numpy as jnp

    a_sp = MATRICES[name]()
    ja, ta, jf, tf = both(a_sp, sweeps=20)
    np.testing.assert_array_equal(tf.rowptr.numpy(), np.asarray(jf.rowptr))
    np.testing.assert_array_equal(tf.colidx.numpy(), np.asarray(jf.colidx))
    np.testing.assert_allclose(tf.vals.numpy(), np.asarray(jf.vals), **TOL)
    for g, w in zip(tilu.split_lu(tf), jilu.split_lu(jf)):
        np.testing.assert_array_equal(g.indptr, w.indptr)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_allclose(g.data, w.data, **TOL)
    r = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    got = tilu.ilu0_apply(tf, torch.from_numpy(r), iters=30).numpy()
    want = np.asarray(jilu.ilu0_apply(jf, jnp.asarray(r), iters=30))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert abs(tilu.ilu0_residual_on_pattern(ta, tf)
               - jilu.ilu0_residual_on_pattern(ja, jf)) < 1e-4


def test_ilu0_matches_exact_lu_on_tridiag():
    a_sp = tridiag()
    f = tilu.ilu0(T.CSR.from_scipy(a_sp, device="cpu"), sweeps=30)
    l, u = tilu.split_lu(f)
    assert abs(l @ u - a_sp).max() < 1e-5


@pytest.mark.parametrize("precond", ["jacobi", "exact", "none"])
def test_pcg_equals_reference(precond):
    import jax.numpy as jnp

    a_sp = jgen.poisson2d(16).astype(np.float32)
    b = np.random.default_rng(1).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    ja, ta, jf, tf = both(a_sp, sweeps=20)
    kw = dict(tol=1e-5, max_iters=150, solve_iters=30)
    if precond == "none":
        tf = jf = None
    else:
        kw["precond"] = precond
    x, hist = tilu.pcg(ta, torch.from_numpy(b), tf, **kw)
    jx, jhist = jilu.pcg(ja, jnp.asarray(b), jf, **kw)
    assert hist[-1] < 1e-5
    assert abs(len(hist) - len(jhist)) <= 1
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-3, atol=1e-4)
    assert np.linalg.norm(b - a_sp @ x) / np.linalg.norm(b) < 1e-3


def test_pcg_rejects_an_unknown_precond():
    a_sp = jgen.poisson2d(4).astype(np.float32)
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    with pytest.raises(ValueError, match="unknown precond"):
        tilu.pcg(ta, torch.ones(ta.m), tilu.ilu0(ta), precond="gauss")
