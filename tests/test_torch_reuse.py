"""The PyTorch port's structure-reuse products (ops/reuse.py: numeric and
triple plans; ops/aggrap.py: the aggregation R·A·P) against the reference
package on the same seeded inputs. Plans and structures equal exactly;
float32 values within rtol 1e-4 / atol 1e-5 (the CLI's tolerance);
where the reference is at fault, against scipy."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.models import amg as jamg
from benchmark_spgemm_using_csr_tpu.ops import aggrap as jaggrap
from benchmark_spgemm_using_csr_tpu.ops import reuse as jreuse
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import aggrap as taggrap
from benchmark_spgemm_using_csr_tpu_torch.ops import reuse as treuse
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import assert_csr_equal

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def same_csr(got, want, **tol):
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **(tol or TOL))


def scipy_csr(c):
    c = c.tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def lengths_of(tails, nnz_c):
    """Per-slot product counts from the reference's exclusive segment ends."""
    return np.diff(np.concatenate([[0], np.asarray(tails)[:nnz_c]]))


def power_law_sym(n=400, seed=7):
    s = jgen.power_law(n, n, alpha=2.0, max_deg=48, seed=seed)
    return (s + s.T).tocsr().astype(np.float32)


PAIRS = {
    "er_rect": lambda: (jgen.erdos_renyi(200, 180, 6.0, seed=3),
                        jgen.erdos_renyi(180, 150, 5.0, seed=11)),
    "power_law_400": lambda: (power_law_sym(), power_law_sym(seed=8)),
    "poisson2d_12": lambda: (jgen.poisson2d(12), jgen.poisson2d(12)),
    "banded": lambda: (jgen.banded(128, bandwidth=5),
                       jgen.erdos_renyi(128, 64, 4.0, seed=2)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_numeric_plan_and_values_equal_reference(name):
    a_sp, b_sp = PAIRS[name]()
    ja, jb = JCSR.from_scipy(a_sp), JCSR.from_scipy(b_sp)
    js = jreuse.make_numeric_plan(ja, jb)
    ts = treuse.make_numeric_plan(bridge(ja), bridge(jb))
    assert ts.plan == treuse.NumericPlan(**vars(js.plan))
    total, nnz_c = ts.plan.total, ts.plan.nnz_c
    np.testing.assert_array_equal(ts.a_idx.numpy(), np.asarray(js.a_idx))
    np.testing.assert_array_equal(ts.b_idx.numpy(), np.asarray(js.b_idx))
    np.testing.assert_array_equal(ts.lengths.numpy(),
                                  lengths_of(js.tails, nnz_c))
    assert int(ts.lengths.sum()) == total
    same_csr(treuse.spgemm_numeric(bridge(ja), bridge(jb), ts),
             jreuse.spgemm_numeric(ja, jb, js))


def test_numeric_value_update_reuses_plan():
    a_sp = jgen.erdos_renyi(300, 300, 7.0, seed=5)
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    sched = treuse.make_numeric_plan(ta, ta)
    rng = np.random.default_rng(9)
    a2_sp = a_sp.copy()
    a2_sp.data = rng.standard_normal(a2_sp.nnz).astype(np.float32)
    ja2 = JCSR.from_scipy(a2_sp, capacity=ta.capacity)
    ta2 = bridge(ja2)
    same_csr(treuse.spgemm_numeric(ta2, ta2, sched),
             jreuse.spgemm_numeric(ja2, ja2,
                                   jreuse.make_numeric_plan(ja2, ja2)))


def test_numeric_empty_rows_and_empty_product():
    a_sp = sp.csr_matrix(
        (np.array([1.0, 2.0], np.float32), (np.array([0, 3]), np.array([1, 2]))),
        shape=(5, 4),
    )
    b_sp = sp.csr_matrix(
        (np.array([3.0], np.float32), (np.array([1]), np.array([0]))),
        shape=(4, 6),
    )
    a = T.CSR.from_scipy(a_sp, device="cpu")
    b = T.CSR.from_scipy(b_sp, device="cpu")
    c = treuse.spgemm_numeric(a, b, treuse.make_numeric_plan(a, b))
    assert_csr_equal(c, scipy_csr(a_sp @ b_sp), rtol=1e-6, atol=1e-7)
    b0 = T.CSR.from_scipy(sp.csr_matrix((4, 6), dtype=np.float32), device="cpu")
    c0 = treuse.spgemm_numeric(a, b0, treuse.make_numeric_plan(a, b0))
    assert int(c0.rowptr[-1]) == 0 and not c0.vals.any()


def test_numeric_dim_mismatch():
    a = T.CSR.from_scipy(jgen.erdos_renyi(10, 11, 2.0, seed=1), device="cpu")
    with pytest.raises(ValueError, match="inner dims"):
        treuse.make_numeric_plan(a, a)


def cancelling_pair(m=2048, n=512, seed=0):
    """A (m, 2m) and B (2m, n) with C = S exactly: A[i, 2i] = A[i, 2i+1] =
    1 and B[2i, c] = B[2i+1, c] = S[i, c] / 2, so every C slot sums two
    equal halves, exact in any order. In destination order S's values
    alternate between magnitude-2**20 entries of either sign, which the
    stream's running sum climbs by and cancels again, and full-mantissa
    values near 1, which a global prefix sum at 2**20 rounds to 1/8."""
    rng = np.random.default_rng(seed)
    s_sp = sp.random(m, n, density=8 / n, random_state=seed, format="csr",
                     dtype=np.float32)
    s_sp.sort_indices()
    t = np.arange(s_sp.nnz)
    big = (2.0 ** 20) * rng.uniform(1.0, 2.0, s_sp.nnz) * np.where(
        t % 4 == 0, 1.0, -1.0)
    small = rng.uniform(0.5, 2.0, s_sp.nnz)
    s_sp.data = np.where(t % 2 == 0, big, small).astype(np.float32)
    rows = np.arange(m)
    a_sp = sp.csr_matrix(
        (np.ones(2 * m, np.float32),
         (np.repeat(rows, 2), np.stack([2 * rows, 2 * rows + 1], 1).ravel())),
        shape=(m, 2 * m),
    )
    coo = s_sp.tocoo()
    half = coo.data / np.float32(2)
    b_sp = sp.csr_matrix(
        (np.concatenate([half, half]),
         (np.concatenate([2 * coo.row, 2 * coo.row + 1]),
          np.concatenate([coo.col, coo.col]))),
        shape=(2 * m, n),
    )
    return a_sp, b_sp, scipy_csr(s_sp)


def cumsum_then_diff(prod, lengths):
    """The global-prefix form the reference's docstring rules out."""
    ends = torch.cumsum(lengths, 0) - 1
    cs = torch.cumsum(prod, 0)[ends]
    return torch.diff(cs, prepend=cs.new_zeros(1))


@pytest.mark.parametrize("form", ["numeric", "triple"])
def test_mixed_sign_cancellation_stays_per_slot(form):
    """Per-slot sums keep C exact where a cumsum-then-diff over the same
    destination-ordered stream misses by far more than the tolerance."""
    a_sp, b_sp, want = cancelling_pair()
    ja, jb = JCSR.from_scipy(a_sp), JCSR.from_scipy(b_sp)
    ta, tb = bridge(ja), bridge(jb)
    if form == "numeric":
        sched = treuse.make_numeric_plan(ta, tb)
        got = treuse.spgemm_numeric(ta, tb, sched)
        jgot = jreuse.spgemm_numeric(ja, jb, jreuse.make_numeric_plan(ja, jb))
        total = sched.plan.total
        prod = (ta.vals[sched.a_idx[:total]] * tb.vals[sched.b_idx[:total]])
    else:
        eye = sp.identity(a_sp.shape[0], np.float32, format="csr")
        jr = JCSR.from_scipy(eye)
        tr = bridge(jr)
        sched = treuse.make_triple_plan(tr, ta, tb)
        got = treuse.spgemm_triple(tr, ta, tb, sched)
        jgot = jreuse.spgemm_triple(jr, ja, jb,
                                    jreuse.make_triple_plan(jr, ja, jb))
        cat = torch.cat([tr.vals[:sched.plan.nnz_r],
                         ta.vals[:sched.plan.nnz_a], tb.vals])
        prod = cat[sched.idx3[:sched.plan.total]].prod(dim=1)
    assert_csr_equal(got, want, **TOL)
    same_csr(got, jgot)
    naive = cumsum_then_diff(prod, sched.lengths).numpy()
    assert not np.allclose(naive, want.data, **TOL)


def test_numeric_bfloat16_accumulates_in_float32():
    a_sp = jgen.erdos_renyi(256, 256, 8.0, seed=4)
    a = T.CSR.from_scipy(a_sp, dtype=np.float32, device="cpu")
    a16 = T.CSR(a.rowptr, a.colidx, a.vals.to(torch.bfloat16), a.shape)
    c = treuse.spgemm_numeric(a16, a16, treuse.make_numeric_plan(a16, a16))
    assert c.vals.dtype == torch.bfloat16
    s16 = a_sp.copy()
    s16.data = a16.vals[: a_sp.nnz].float().numpy()
    assert_csr_equal(T.CSR(c.rowptr, c.colidx, c.vals.float(), c.shape),
                     scipy_csr(s16 @ s16), rtol=2e-2, atol=1e-2)


def triple_case(n_grid=16, seed=3):
    a_sp = jgen.poisson2d(n_grid).tocsr().astype(np.float32)
    rng = np.random.default_rng(seed)
    a_sp.data = a_sp.data + 0.01 * rng.standard_normal(a_sp.nnz).astype(
        np.float32)
    p_sp = jamg.aggregation_prolongator(a_sp).astype(np.float32).tocsr()
    return p_sp.T.tocsr(), a_sp, p_sp


TRIPLES = {
    "aggregation": triple_case,
    "general_rect": lambda: (jgen.erdos_renyi(40, 60, 3.0, seed=1),
                             jgen.erdos_renyi(60, 50, 4.0, seed=2),
                             jgen.erdos_renyi(50, 30, 3.0, seed=3)),
}


@pytest.mark.parametrize("name", sorted(TRIPLES))
def test_triple_plan_and_values_equal_reference(name):
    jr, ja, jp = map(JCSR.from_scipy, TRIPLES[name]())
    js = jreuse.make_triple_plan(jr, ja, jp)
    ts = treuse.make_triple_plan(bridge(jr), bridge(ja), bridge(jp))
    assert ts.plan == treuse.TriplePlan(**vars(js.plan))
    np.testing.assert_array_equal(ts.idx3.numpy(), np.asarray(js.idx3))
    np.testing.assert_array_equal(ts.lengths.numpy(),
                                  lengths_of(js.tails, ts.plan.nnz_c))
    same_csr(treuse.spgemm_triple(bridge(jr), bridge(ja), bridge(jp), ts),
             jreuse.spgemm_triple(jr, ja, jp, js))


def test_triple_values_update_and_product_gate():
    r_sp, a_sp, p_sp = TRIPLES["general_rect"]()
    tr, ta, tp = (T.CSR.from_scipy(x, device="cpu") for x in (r_sp, a_sp, p_sp))
    sched = treuse.make_triple_plan(tr, ta, tp)
    a2_sp = a_sp.copy()
    a2_sp.data = np.random.default_rng(11).standard_normal(
        a2_sp.nnz).astype(np.float32)
    ta2 = T.CSR.from_scipy(a2_sp, capacity=ta.capacity, device="cpu")
    assert_csr_equal(treuse.spgemm_triple(tr, ta2, tp, sched),
                     scipy_csr(r_sp @ (a2_sp @ p_sp)), **TOL)
    assert treuse.make_triple_plan(tr, ta, tp, max_products=10) is None
    assert jreuse.make_triple_plan(*map(JCSR.from_scipy, (r_sp, a_sp, p_sp)),
                                   max_products=10) is None


def aggregation_cases():
    rng = np.random.default_rng(0)

    def weighted():
        r_sp, a_sp, p_sp = triple_case(12)
        p_sp = p_sp.copy()
        p_sp.data = rng.uniform(0.5, 2.0, p_sp.nnz).astype(np.float32)
        return p_sp.T.tocsr(), a_sp, p_sp

    def er_graph():
        a_sp = jgen.erdos_renyi(400, 400, 6.0, seed=3)
        a_sp = (a_sp + a_sp.T).tocsr().astype(np.float32)
        p_sp = jamg.aggregation_prolongator(a_sp).astype(np.float32).tocsr()
        return p_sp.T.tocsr(), a_sp, p_sp

    return {"poisson2d_16": triple_case, "weighted_p": weighted,
            "er_graph_400": er_graph}


AGG = aggregation_cases()


@pytest.mark.parametrize("name", sorted(AGG))
def test_aggrap_plan_and_values_equal_reference(name):
    jr, ja, jp = map(JCSR.from_scipy, AGG[name]())
    js = jaggrap.make_aggrap_plan(jr, ja, jp)
    ts = taggrap.make_aggrap_plan(bridge(jr), bridge(ja), bridge(jp))
    assert js is not None and ts is not None
    want = {k: v for k, v in vars(js.plan).items()}
    got = {k: v for k, v in vars(ts.plan).items() if k != "sentinel"}
    assert got == want
    nnz_a = ts.plan.nnz_a
    ibits = max(int(ts.plan.m_c - 1).bit_length(), 1)
    assert ts.plan.sentinel == 1 << (ibits + ts.plan.cbits)
    np.testing.assert_array_equal(ts.keys.numpy()[:nnz_a],
                                  np.asarray(js.keys)[:nnz_a])
    assert (ts.keys.numpy()[nnz_a:] == ts.plan.sentinel).all()
    np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))
    np.testing.assert_array_equal(ts.rowptr.numpy(), np.asarray(js.rowptr))
    same_csr(taggrap.rap_aggregation(bridge(ja), ts),
             jaggrap.rap_aggregation(ja, js))


def test_aggrap_gates_equal_reference():
    """A non-aggregation P (two entries in a row) fails the gate in both
    packages; float64 values fail it in the port (the reference's float64
    gate needs x64, which its CPU tests leave off)."""
    r_sp, a_sp, p_sp = triple_case(8)
    p2 = p_sp.tolil()
    p2[0, p_sp.shape[1] - 1 - p_sp.indices[0]] = 1.0
    p2 = p2.tocsr()
    assert p2.getnnz(axis=1)[0] == 2
    r2 = p2.T.tocsr()
    assert jaggrap.make_aggrap_plan(*(JCSR.from_scipy(x)
                                      for x in (r2, a_sp, p2))) is None
    assert taggrap.make_aggrap_plan(*(T.CSR.from_scipy(x, device="cpu")
                                      for x in (r2, a_sp, p2))) is None
    assert taggrap.make_aggrap_plan(*(
        T.CSR.from_scipy(x, device="cpu")
        for x in (r_sp, a_sp.astype(np.float64), p_sp))) is None


def test_aggrap_keeps_the_last_entry_at_32_key_bits():
    """131072 fine rows aggregated in pairs onto a 65536 x 65536 coarse
    level: ibits + cbits == 32, which the gate admits. The port equals
    scipy, entry (65535, 65535) included. The reference package gives that
    entry the key 0xFFFFFFFF, its padding sentinel, so its run-sum drops
    the value: its C holds 0 there (asserted below as a record of the
    fault; ROADMAP queue 3)."""
    n = 131072
    a_sp = sp.diags([np.full(n, 2.0), np.full(n - 1, -1.0),
                     np.full(n - 1, -1.0)], [0, 1, -1],
                    format="csr").astype(np.float32)
    p_sp = sp.csr_matrix((np.ones(n, np.float32),
                          (np.arange(n), np.arange(n) // 2)),
                         shape=(n, n // 2))
    r_sp = p_sp.T.tocsr()
    ta = T.CSR.from_scipy(a_sp, device="cpu")
    ts = taggrap.make_aggrap_plan(T.CSR.from_scipy(r_sp, device="cpu"), ta,
                                  T.CSR.from_scipy(p_sp, device="cpu"))
    assert ts.plan.cbits + max(int(ts.plan.m_c - 1).bit_length(), 1) == 32
    got = taggrap.rap_aggregation(ta, ts)
    want = scipy_csr(r_sp @ (a_sp @ p_sp))
    last = n // 2 - 1
    assert want[last, last] == 2.0
    assert_csr_equal(got, want, **TOL)
    assert got.to_scipy()[last, last] == 2.0

    ja = JCSR.from_scipy(a_sp)
    js = jaggrap.make_aggrap_plan(JCSR.from_scipy(r_sp), ja,
                                  JCSR.from_scipy(p_sp))
    assert jaggrap.rap_aggregation(ja, js).to_scipy()[last, last] == 0.0
