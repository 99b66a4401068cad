"""The PyTorch port's DIA path (sparse/dia.py, ops/dia.py, the plain
version of kernel K3 and the dia estimator) against the reference package
on the same numpy inputs.

Tolerances: the gather form and K3's plain version sum each output plane's
terms in the reference's order, float32 at rtol 1e-6 / atol 1e-6 against
the reference's gather form (XLA may contract a multiply-add); K3's plain
version against the Pallas kernel in interpret mode at rtol 1e-5 / atol
1e-6, the reference's own tolerance (tests/test_dia_pallas.py); float64
against the x64 scipy product at rtol / atol 1e-12. Offsets and CSR
structures compare exactly."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.ops import dia as jdia
from benchmark_spgemm_using_csr_tpu.ops import dispatch as jdispatch
from benchmark_spgemm_using_csr_tpu.ops.dia_pallas import (
    dia_spgemm_fused as pallas_dia_spgemm_fused,
)
from benchmark_spgemm_using_csr_tpu.sparse.dia import DIA as JDIA
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import dia as tdia
from benchmark_spgemm_using_csr_tpu_torch.ops import dia_convert, dia_kernels
from benchmark_spgemm_using_csr_tpu_torch.ops import dispatch as tdispatch

torch.set_num_threads(2)

GATHER_TOL = dict(rtol=1e-6, atol=1e-6)
PALLAS_TOL = dict(rtol=1e-5, atol=1e-6)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


def rect_pair():
    rng = np.random.default_rng(0)
    a = sp.diags([rng.standard_normal(40), rng.standard_normal(40)],
                 [0, 3], shape=(40, 43), format="csr").astype(np.float32)
    b = sp.diags([rng.standard_normal(40), rng.standard_normal(43)],
                 [-3, 2], shape=(43, 50), format="csr").astype(np.float32)
    return a, b


PAIRS = {
    "poisson2d_16": lambda: (jgen.poisson2d(16),) * 2,
    "banded_ab": lambda: (jgen.banded(512, bandwidth=3, seed=1),
                          jgen.banded(512, bandwidth=5, seed=2)),
    "stencil27_6": lambda: (jgen.stencil27(6),) * 2,
    "rectangular": rect_pair,
    "single_offdiag": lambda: (sp.diags([np.arange(1.0, 30.0)], [-4],
                                        shape=(33, 33), format="csr")
                               .astype(np.float32),) * 2,
    "zero": lambda: (sp.csr_matrix((24, 24), dtype=np.float32),) * 2,
}


def same_csr_at_slot_capacity(got, want, planes):
    """``got`` (``DIA.to_csr`` of ``planes``) holds the reference's CSR
    ``want``: rowptr equal, colidx and vals equal up to nnz, zero past
    it, at the capacity ``pad_bucket`` of the planes' in-matrix slots
    (the reference's is ``pad_bucket(nnz)``)."""
    nnz = int(want.rowptr[-1])
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx[:nnz].numpy(),
                                  np.asarray(want.colidx)[:nnz])
    np.testing.assert_allclose(got.vals[:nnz].numpy(),
                               np.asarray(want.vals)[:nnz], **GATHER_TOL)
    assert not got.colidx[nnz:].any() and not got.vals[nnz:].any()
    assert got.capacity == dia_convert.capacity(planes.offsets, *planes.shape)


def both_dia(a_sp, b_sp):
    return ((JDIA.from_scipy(a_sp), JDIA.from_scipy(b_sp)),
            (T.DIA.from_scipy(a_sp, device="cpu"),
             T.DIA.from_scipy(b_sp, device="cpu")))


# ---- the container ---------------------------------------------------------


@pytest.mark.parametrize("name", ["poisson2d_16", "banded_ab", "rectangular",
                                  "single_offdiag"])
def test_from_scipy_matches_reference(name):
    a_sp, _ = PAIRS[name]()
    want = JDIA.from_scipy(a_sp)
    got = T.DIA.from_scipy(a_sp, device="cpu")
    assert got.offsets == want.offsets and got.shape == want.shape
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.valid_mask(), want.valid_mask())
    assert (got.ndiag, got.m, got.n) == (want.ndiag, want.m, want.n)


def test_scipy_garbage_outside_the_matrix_is_zeroed():
    """scipy keeps raw plane values in out-of-matrix slots; the container
    zeroes them (the invariant the products rely on)."""
    data = np.arange(1.0, 17.0, dtype=np.float32).reshape(2, 8)
    mat = sp.dia_matrix((data, [-2, 3]), shape=(8, 8))
    got = T.DIA.from_scipy(mat, device="cpu")
    want = JDIA.from_scipy(mat)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert (got.data.numpy()[~got.valid_mask()] == 0).all()


@pytest.mark.parametrize("name", ["poisson2d_16", "banded_ab", "rectangular"])
def test_from_csr_matches_reference(name):
    a_sp, _ = PAIRS[name]()
    ja = J.CSR.from_scipy(a_sp)
    want = JDIA.from_csr(ja)
    got = T.DIA.from_csr(bridge(ja), device="cpu")
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    # explicit offsets: a superset keeps the extra planes empty
    extra = tuple(want.offsets) + (max(want.offsets) + 1,)
    want_x = JDIA.from_csr(ja, offsets=extra)
    got_x = T.DIA.from_csr(bridge(ja), offsets=extra, device="cpu")
    assert got_x.offsets == want_x.offsets
    np.testing.assert_array_equal(got_x.data.numpy(), np.asarray(want_x.data))


def test_from_csr_rejects_entries_off_the_offsets():
    ja = J.CSR.from_scipy(jgen.poisson2d(8))
    for offsets in ((-1, 0, 1), (-8, -1, 0, 1, 9), (100,)):
        with pytest.raises(ValueError, match="diagonal"):
            JDIA.from_csr(ja, offsets=offsets)
        with pytest.raises(ValueError, match="diagonal"):
            T.DIA.from_csr(bridge(ja), offsets=offsets, device="cpu")


@pytest.mark.parametrize("name", ["poisson2d_16", "banded_ab", "stencil27_6",
                                  "rectangular"])
def test_to_csr_matches_reference(name):
    a_sp, b_sp = PAIRS[name]()
    (ja, jb), (ta, tb) = both_dia(a_sp, b_sp)
    want = jdia.dia_spgemm(ja, jb, fused=False).to_csr(prune=True)
    c = tdia.dia_spgemm(ta, tb)
    got = c.to_csr(prune=True)
    same_csr_at_slot_capacity(got, want, c)


def test_round_trips():
    a_sp = jgen.poisson2d(16)
    a = T.CSR.from_scipy(a_sp, device="cpu")
    d = T.DIA.from_csr(a, device="cpu")
    # prune=False keeps every in-matrix slot: the structure widens to full
    # diagonals, the values match densely
    wide = d.to_csr(prune=False)
    assert int(wide.rowptr[-1]) == int(d.valid_mask().sum())
    np.testing.assert_array_equal(wide.to_scipy().toarray(), a_sp.toarray())
    back = d.to_csr(prune=True)
    np.testing.assert_array_equal(back.rowptr.numpy(), a.rowptr.numpy())
    np.testing.assert_array_equal(back.colidx.numpy(), a.colidx.numpy())
    np.testing.assert_array_equal(back.vals.numpy(), a.vals.numpy())
    np.testing.assert_array_equal(d.to_scipy().toarray(), a_sp.toarray())
    e = T.DIA.from_scipy(sp.csr_matrix((5, 7), dtype=np.float32),
                         device="cpu")
    assert e.ndiag == 0 and int(e.to_csr().rowptr[-1]) == 0


# ---- the gather form ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_gather_form_matches_reference(name):
    a_sp, b_sp = PAIRS[name]()
    (ja, jb), (ta, tb) = both_dia(a_sp, b_sp)
    want = jdia.dia_spgemm(ja, jb, fused=False)
    got = tdia.dia_spgemm(ta, tb, fused=False)
    assert got.offsets == want.offsets and got.shape == want.shape
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **GATHER_TOL)
    dense = (a_sp @ b_sp).toarray()
    np.testing.assert_allclose(got.to_scipy().toarray(), dense, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["poisson2d_16", "rectangular"])
def test_float64_against_x64_scipy(name):
    a_sp, b_sp = (x.astype(np.float64) for x in PAIRS[name]())
    ta = T.DIA.from_scipy(a_sp, device="cpu")
    tb = T.DIA.from_scipy(b_sp, device="cpu")
    for fused in (False, True):
        got = tdia.dia_spgemm(ta, tb, fused=fused)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.to_scipy().toarray(),
                                   (a_sp @ b_sp).toarray(), rtol=1e-12,
                                   atol=1e-12)


def test_inner_dims_mismatch_raises():
    a = T.DIA.from_scipy(jgen.poisson2d(4), device="cpu")
    b = T.DIA.from_scipy(jgen.poisson2d(5), device="cpu")
    with pytest.raises(ValueError, match="inner dims"):
        tdia.dia_spgemm(a, b)
    with pytest.raises(ValueError, match="inner dims"):
        dia_kernels.dia_spgemm_fused(a, b)


def test_auto_gate_keeps_the_gather_form_on_cpu():
    """fused=None mirrors the reference's gate with a CUDA device in place
    of the TPU backend: CPU planes keep the gather form, even where the
    other terms of the gate hold (n >= 2^18, few diagonals, float32)."""
    a = T.DIA.from_scipy(jgen.banded(1 << 18, bandwidth=1), device="cpu")
    before = dia_kernels.dia_spgemm_fused.launches
    c = tdia.dia_spgemm(a, a)
    want = tdia.dia_spgemm(a, a, fused=False)
    assert dia_kernels.dia_spgemm_fused.launches == before
    assert c.offsets == want.offsets
    assert torch.equal(c.data, want.data)


def test_span_past_4096_widens_k3s_block():
    """A B span past the reference's 4096: K3 under the reference contract
    raises, dia_spgemm's K3 route widens bj to the span (CPU planes: K3's
    plain version) and equals the gather form bit for bit; fused=None on
    CPU planes keeps the gather form."""
    rng = np.random.default_rng(5)
    offsets = (-4600, -1, 0, 1, 990)  # span 5590, consph_83k's
    a = T.DIA.from_numpy(rng.standard_normal((5, 12000)).astype(np.float32),
                         offsets, (12000, 12000), device="cpu")
    with pytest.raises(ValueError, match="span"):
        dia_kernels.dia_spgemm_fused(a, a)
    want = dia_kernels.gather_form(a, a)
    before = dia_kernels.dia_spgemm_fused.launches
    for fused in (True, None):
        got = tdia.dia_spgemm(a, a, fused=fused)
        assert got.offsets == want.offsets
        assert torch.equal(got.data, want.data)
    assert dia_kernels.dia_spgemm_fused.launches == before


def test_spmv_matches_reference():
    import jax.numpy as jnp

    for a_sp in (jgen.stencil27(5), PAIRS["rectangular"]()[0]):
        x = np.linspace(-1, 1, a_sp.shape[1]).astype(np.float32)
        want = np.asarray(jdia.dia_spmv(JDIA.from_scipy(a_sp),
                                        jnp.asarray(x)))
        got = tdia.dia_spmv(T.DIA.from_scipy(a_sp, device="cpu"),
                            torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), a_sp @ x, rtol=1e-4,
                                   atol=1e-5)


# ---- K3's plain version against the Pallas kernel --------------------------


@pytest.mark.parametrize("name,bj", [
    ("poisson2d_16", 128),  # offsets +-16, n = 256
    ("banded_ab", 256),  # asymmetric bands
    ("ragged", 128),  # n = 300, not a multiple of bj
    ("stencil27_6", 512),  # 27 diagonals, 125 output planes
    ("rectangular", 64),
])
def test_fused_plain_matches_pallas(name, bj):
    if name == "ragged":
        a_sp = b_sp = jgen.banded(300, bandwidth=2, seed=3)
    else:
        a_sp, b_sp = PAIRS[name]()
    (ja, jb), (ta, tb) = both_dia(a_sp, b_sp)
    want = pallas_dia_spgemm_fused(ja, jb, bj=bj, interpret=True)
    before = dia_kernels.dia_spgemm_fused.launches
    got = dia_kernels.dia_spgemm_fused(ta, tb, bj=bj)
    assert dia_kernels.dia_spgemm_fused.launches == before  # CPU: plain
    assert got.offsets == want.offsets and got.shape == want.shape
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **PALLAS_TOL)
    # the plain version is the gather form that dia_spgemm runs off K3
    assert torch.equal(got.data, tdia.dia_spgemm(ta, tb, fused=False).data)


def test_fused_span_guard():
    a_sp = jgen.banded(256, bandwidth=4)
    (ja, _), (ta, _) = both_dia(a_sp, a_sp)
    with pytest.raises(ValueError, match="span"):
        pallas_dia_spgemm_fused(ja, ja, bj=2, interpret=True)
    with pytest.raises(ValueError, match="span"):
        dia_kernels.dia_spgemm_fused(ta, ta, bj=2)
    with pytest.raises(ValueError, match="span"):
        dia_kernels.dia_spgemm_fused_plain(ta, ta, bj=2)


def test_fused_empty_operand():
    z = sp.csr_matrix((16, 16), dtype=np.float32)
    a_sp = jgen.poisson2d(4)
    for x, y in ((z, a_sp), (a_sp, z)):
        (ja, jb), (ta, tb) = both_dia(x, y)
        want = pallas_dia_spgemm_fused(ja, jb, interpret=True)
        got = dia_kernels.dia_spgemm_fused(ta, tb)
        assert got.offsets == want.offsets == (0,)
        assert got.data.shape == (1, 16) and not got.data.any()


def test_fused_wrapper_rejects_bad_inputs():
    a = T.DIA.from_scipy(jgen.poisson2d(4), device="cpu")
    meta = T.DIA(torch.zeros(a.data.shape, device="meta"), a.offsets, a.shape)
    with pytest.raises(ValueError, match="device"):
        dia_kernels.dia_spgemm_fused(meta, meta)
    with pytest.raises(ValueError, match="planes on"):
        dia_kernels.dia_spgemm_fused(a, meta)
    ints = T.DIA(a.data.to(torch.int32), a.offsets, a.shape)
    with pytest.raises(TypeError, match="float"):
        dia_kernels.dia_spgemm_fused(ints, ints)


def test_term_table_is_a_csr_over_the_output_planes():
    """K3's launch plan: each plane's terms, decoded from its item's entries
    through its group's staged rows, are ``plan_terms``' (s1, s2, d2) in
    ascending B slot; the plan is built once per offset pair and shape."""
    off_a, off_b = (-2, 0, 3), (-1, 4)
    plan = dia_kernels.launch_plan(off_a, off_b, 50, 4)
    off_c, by_plane = dia_kernels.plan_terms(off_a, off_b)
    q_max = dia_kernels.PLANES_PER_ITEM
    assert len(plan.plane_terms) == len(off_c)
    for p0, count, row0, nb, na, term0, _, _ in plan.groups:
        rows = plan.rows[row0:row0 + nb + na]
        b_at = {4 * at: slot for slot, _, _, at in rows[:nb]}
        got = {p: [] for p in range(p0, p0 + count)}
        for first, _, start, end in plan.plane_terms[p0:p0 + -(-count // q_max)]:
            i = p0 + first
            for bo, *aos in plan.terms[term0 + start:term0 + end].tolist():
                for q, ao in enumerate(aos):
                    if ao < 0:
                        continue
                    s1, d2 = next((slot, shift - (ao - 4 * at) // 4)
                                  for slot, shift, width, at in rows[nb:]
                                  if 4 * at <= ao < 4 * (at + width))
                    got[i + q].append((int(s1), b_at[bo], int(d2)))
        for p in got:
            assert got[p] == by_plane[off_c[p]]
            assert all(off_a[s1] + d2 == off_c[p] for s1, _, d2 in got[p])
    assert dia_kernels.launch_plan(off_a, off_b, 50, 4) is plan


# ---- CSR facade and dispatch ---------------------------------------------------


@pytest.mark.parametrize("name", ["poisson2d_16", "stencil27_6", "zero"])
def test_spgemm_dia_same_csr_as_reference(name):
    a_sp, _ = PAIRS[name]()
    ja = J.CSR.from_scipy(a_sp)
    want = jdia.spgemm_dia(ja, ja)
    got = T.spgemm_dia(bridge(ja), bridge(ja))
    d = T.DIA.from_csr(bridge(ja), device="cpu")
    same_csr_at_slot_capacity(got, want, tdia.dia_spgemm(d, d))
    # the facade trims C to pad_bucket(nnz), the reference's capacity
    for method in ("dia", "auto"):
        jc = J.spgemm(ja, ja, method=method)
        tc = T.spgemm(bridge(ja), bridge(ja), method=method)
        np.testing.assert_array_equal(tc.rowptr.numpy(),
                                      np.asarray(jc.rowptr))
        np.testing.assert_array_equal(tc.colidx.numpy(),
                                      np.asarray(jc.colidx))
        np.testing.assert_allclose(tc.vals.numpy(), np.asarray(jc.vals),
                                   rtol=1e-4, atol=1e-5)


def test_spgemm_dia_rectangular_pair():
    a_sp, b_sp = PAIRS["rectangular"]()
    ja, jb = J.CSR.from_scipy(a_sp), J.CSR.from_scipy(b_sp)
    want = jdia.spgemm_dia(ja, jb)
    got = T.spgemm(bridge(ja), bridge(jb), method="dia")
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **GATHER_TOL)


@pytest.mark.parametrize("name", ["poisson2d_64", "banded_ab", "stencil27_6",
                                  "zero"])
def test_offsets_viable_and_estimate_match_reference(name):
    a_sp = (jgen.SUITE[name]() if name in jgen.SUITE else PAIRS[name]()[0])
    ja = J.CSR.from_scipy(a_sp)
    ta = bridge(ja)
    np.testing.assert_array_equal(tdia.dia_offsets_of(ta),
                                  jdia.dia_offsets_of(ja))
    assert tdispatch.estimate_dia_s(ta) == jdispatch.estimate_dia_s(ja)


@pytest.mark.parametrize("name", ["poisson2d_64", "banded_16k", "er_small",
                                  "stencil27_32"])
def test_dia_viable_matches_reference(name):
    ja = J.CSR.from_scipy(jgen.SUITE[name]())
    assert T.dia_viable(bridge(ja)) == jdia.dia_viable(ja)


def test_root_exports_match_reference():
    from benchmark_spgemm_using_csr_tpu_torch.ops import fused as tfused

    for name in ("dia_spmv", "dia_viable", "make_fused_plan"):
        assert name in J.__all__ and name in T.__all__
    assert T.dia_spmv is tdia.dia_spmv and T.dia_viable is tdia.dia_viable
    assert T.make_fused_plan is tfused.make_plan


def test_dia_estimate_refuses_iid_random():
    ja = J.CSR.from_scipy(jgen.erdos_renyi(1024, 1024, 8.0))
    assert not jdia.dia_viable(ja)
    assert tdispatch.estimate_dia_s(bridge(ja)) == float("inf")


# the reference routes these suite matrices to dia (results.jsonl); the
# estimators are host numpy, so full size is cheap here
@pytest.mark.parametrize("name", ["poisson2d_256", "banded_16k",
                                  "stencil27_32", "pdb_8k"])
def test_choose_method_picks_dia_as_the_reference(name):
    ja = J.CSR.from_scipy(jgen.SUITE[name]())
    ta = bridge(ja)
    assert J.choose_method(ja, ja) == "dia"
    assert T.choose_method(ta, ta) == "dia"
