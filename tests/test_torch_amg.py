"""The PyTorch port's AMG model (models/amg.py) against the reference
package on the same seeded inputs: the host aggregation element for
element, every level of the hierarchy (structure exactly, float32 values
within rtol 1e-4 / atol 1e-5), the numeric refresh through aggrap and the
triple plan, the V-cycle and the solver's history, and a hierarchy carried
across from the reference package (its save, the port's load)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.models import amg as jamg
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch import compat
from benchmark_spgemm_using_csr_tpu_torch.models import amg as tamg
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import assert_csr_equal

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def same_csr(got, want, **tol):
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **(tol or TOL))


def same_pruned(got, want, **tol):
    """Both CSRs as scipy matrices, exact structure and values within tol."""
    g, w = got.to_scipy(), want.to_scipy()
    for c in (g, w):
        c.sum_duplicates()
        c.sort_indices()
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_allclose(g.data, w.data, **(tol or TOL))


def power_law_sym(n=400, seed=7):
    s = jgen.power_law(n, n, alpha=2.0, max_deg=48, seed=seed)
    s = (s + s.T).tocsr()
    return (s + sp.identity(n, format="csr") * 4.0).tocsr().astype(np.float32)


MATRICES = {
    "poisson2d_8": lambda: jgen.poisson2d(8).astype(np.float32),
    "poisson2d_12": lambda: jgen.poisson2d(12).astype(np.float32),
    "power_law_400": power_law_sym,
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_aggregation_prolongator_equals_reference(name):
    a_sp = MATRICES[name]()
    got = tamg.aggregation_prolongator(a_sp)
    want = jamg.aggregation_prolongator(a_sp)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_galerkin_product_equals_reference(name):
    a_sp = MATRICES[name]()
    p_sp = jamg.aggregation_prolongator(a_sp)
    got = tamg.galerkin_product(T.CSR.from_scipy(a_sp, device="cpu"),
                                T.CSR.from_scipy(p_sp, device="cpu"))
    same_pruned(got, jamg.galerkin_product(JCSR.from_scipy(a_sp),
                                           JCSR.from_scipy(p_sp)))


def hierarchies(a_sp, smooth):
    return (tamg.build_hierarchy(a_sp, min_coarse=16, smooth=smooth,
                                 device="cpu"),
            jamg.build_hierarchy(a_sp, min_coarse=16, smooth=smooth))


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("name", ["poisson2d_12", "power_law_400"])
def test_build_hierarchy_levels_equal_reference(name, smooth):
    th, jh = hierarchies(MATRICES[name](), smooth)
    assert [lv.a.shape for lv in th.levels] == [lv.a.shape for lv in jh.levels]
    assert len(th.levels) >= 2
    for tl, jl in zip(th.levels[1:], jh.levels[1:]):
        same_pruned(tl.p, jl.p)
        same_pruned(tl.r, jl.r)
        same_pruned(tl.a, jl.a)


@pytest.mark.parametrize("smooth,route", [(False, "agg"), (True, "triple")])
def test_numeric_refresh_equals_fresh_build_and_reference(smooth, route):
    """New values on the same structure: every coarse level equals scipy's
    R·A·P with the hierarchy's own P and R, and the reference's refresh;
    an unsmoothed P refreshes through aggrap, a smoothed one through the
    triple plan."""
    a_sp = MATRICES["poisson2d_12"]()
    th, jh = hierarchies(a_sp, smooth)
    rng = np.random.default_rng(5)
    a2_sp = a_sp.copy()
    a2_sp.data = (a2_sp.data * 1.5 + 0.05 * rng.standard_normal(a2_sp.nnz)
                  ).astype(np.float32)
    t2 = tamg.numeric_refresh(th, T.CSR.from_scipy(a2_sp, device="cpu"))
    j2 = jamg.numeric_refresh(jh, JCSR.from_scipy(a2_sp))
    assert [k for k, _ in t2._triple_plans[1:]] == [route] * (
        len(th.levels) - 1)
    assert [k for k, _ in t2._triple_plans[1:]] == [
        k for k, _ in j2._triple_plans[1:]]
    cur = a2_sp
    for li in range(1, len(th.levels)):
        p_sp = th.levels[li].p.to_scipy()
        r_sp = th.levels[li].r.to_scipy()
        want = (r_sp @ (cur @ p_sp)).tocsr()
        want.sum_duplicates()
        want.sort_indices()
        assert_csr_equal(t2.levels[li].a, want, rtol=1e-4, atol=1e-4)
        same_pruned(t2.levels[li].a, j2.levels[li].a)
        cur = want
    # a second refresh reuses the cached plans
    plans = list(t2._triple_plans)
    t3 = tamg.numeric_refresh(t2, T.CSR.from_scipy(a2_sp, device="cpu"))
    assert all(x is y for x, y in zip(plans, t3._triple_plans))


def carried(jh, device="cpu"):
    """The reference hierarchy's levels as host tuples, into the port."""
    def tup(c):
        return (np.asarray(c.rowptr), np.asarray(c.colidx),
                np.asarray(c.vals), c.shape)
    return compat.amg_hierarchy_from_levels(
        [(tup(lv.a), None if lv.p is None else tup(lv.p)) for lv in jh.levels],
        device=device)


@pytest.mark.parametrize("smooth", [False, True])
def test_v_cycle_equals_reference(smooth):
    import jax.numpy as jnp

    a_sp = MATRICES["poisson2d_12"]()
    jh = jamg.build_hierarchy(a_sp, min_coarse=16, smooth=smooth)
    b = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    want = np.asarray(jamg.v_cycle(jh, jnp.asarray(b)))
    th = tamg.build_hierarchy(a_sp, min_coarse=16, smooth=smooth, device="cpu")
    for h in (th, carried(jh)):
        got = tamg.v_cycle(h, torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_solve_history_equals_reference():
    a_sp = jgen.poisson2d(16).astype(np.float32)
    b = np.random.default_rng(0).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    x, hist = tamg.solve(a_sp, b, tol=1e-4, max_iters=40, device="cpu")
    jx, jhist = jamg.solve(a_sp, b, tol=1e-4, max_iters=40)
    assert hist[-1] < 1e-4
    assert len(hist) == len(jhist)
    np.testing.assert_allclose(hist, jhist, rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-3, atol=1e-4)
    assert np.linalg.norm(b - a_sp @ x) / np.linalg.norm(b) < 1e-3


def test_hierarchy_saved_by_reference_loads_in_port(tmp_path):
    """The carry-across: the reference's AMGHierarchy.save, the port's
    load (and the compat bridge from host tuples) give the same V-cycle."""
    import jax.numpy as jnp

    a_sp = MATRICES["poisson2d_12"]()
    jh = jamg.build_hierarchy(a_sp, min_coarse=16, smooth=True)
    prefix = str(tmp_path / "h")
    jh.save(prefix)
    th = tamg.AMGHierarchy.load(prefix, len(jh.levels), device="cpu")
    b = np.random.default_rng(3).standard_normal(a_sp.shape[0]).astype(
        np.float32)
    want = np.asarray(jamg.v_cycle(jh, jnp.asarray(b)))
    for h in (th, carried(jh)):
        assert len(h.levels) == len(jh.levels)
        for tl, jl in zip(h.levels, jh.levels):
            same_csr(tl.a, jl.a, rtol=0, atol=0)
        got = tamg.v_cycle(h, torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # and back: the port's save loads in the reference package
    th.save(str(tmp_path / "t"))
    back = jamg.AMGHierarchy.load(str(tmp_path / "t"), len(jh.levels))
    for bl, jl in zip(back.levels, jh.levels):
        np.testing.assert_array_equal(np.asarray(bl.a.vals),
                                      np.asarray(jl.a.vals))


def test_entry_points_need_the_card_they_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a_sp = MATRICES["poisson2d_8"]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamg.build_hierarchy(a_sp, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamg.build_hierarchy(a_sp)  # the default is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamg.solve(a_sp, np.ones(a_sp.shape[0], np.float32))
