"""The PyTorch port's numeric paths (esc, chunked, grouped, tilepack)
against the reference package's on the same inputs.

- rowptr and colidx equal exactly;
- values within rtol 1e-4 / atol 1e-5 (utils/oracle.assert_csr_equal's
  float32 tolerance as the CLI uses it: duplicate sums run in another
  order);
- host plans equal field for field (the port's plans carry a subset of
  the reference's fields: the TPU-only ones are not ported), and the
  schedules' index arrays equal exactly; a chunked plan on the row-local
  route (a field the reference lacks) sizes C at ``pad_gentle(nnz(C))``
  in place of the reference's bound, held apart;
- float64 (grouped) against the x64 scipy oracle at rtol/atol 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.ops import chunked as jc
from benchmark_spgemm_using_csr_tpu.ops import grouped as jg
from benchmark_spgemm_using_csr_tpu.ops import tilepack as jt
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import chunked as tc
from benchmark_spgemm_using_csr_tpu_torch.ops import grouped as tg
from benchmark_spgemm_using_csr_tpu_torch.ops import kernels, rowlocal
from benchmark_spgemm_using_csr_tpu_torch.ops import tilepack as tt
from benchmark_spgemm_using_csr_tpu_torch.ops.stream import pad_gentle
from benchmark_spgemm_using_csr_tpu_torch.utils import generators as tgen
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-5)


def bridge(j):
    return T.CSR.from_numpy(np.asarray(j.rowptr), np.asarray(j.colidx),
                            np.asarray(j.vals), j.shape, device="cpu")


MATRICES = {
    "er_small": lambda: (jgen.SUITE["er_small"](),) * 2,
    "powerlaw_small": lambda: (jgen.SUITE["powerlaw_small"](),) * 2,
    "poisson2d_64": lambda: (jgen.SUITE["poisson2d_64"](),) * 2,
    "circuit": lambda: (jgen.circuit(2048, seed=3),) * 2,
    "rect": lambda: jgen.rect_pair(600, 300, 500, seed=7),
}

_OPERANDS = {}


def operands(name):
    """(reference A, B, port A, B), built once per matrix."""
    if name not in _OPERANDS:
        sa, sb = MATRICES[name]()
        ja = J.CSR.from_scipy(sa)
        jb = ja if sb is sa else J.CSR.from_scipy(sb)
        ta = bridge(ja)
        tb = ta if jb is ja else bridge(jb)
        _OPERANDS[name] = (ja, jb, ta, tb)
    return _OPERANDS[name]


def assert_same_csr(j, t):
    rowptr = np.asarray(j.rowptr)
    nnz = int(rowptr[-1])
    np.testing.assert_array_equal(t.rowptr.numpy(), rowptr)
    np.testing.assert_array_equal(t.colidx.numpy()[:nnz],
                                  np.asarray(j.colidx)[:nnz])
    np.testing.assert_allclose(t.vals.numpy()[:nnz], np.asarray(j.vals)[:nnz],
                               **F32_TOL)


def assert_same_plan(jp, tp):
    """The port's plan equals the reference's on the reference's fields;
    on the chunked plan's row-local route, but for ``out_cap`` (C's exact
    size there, held by the caller)."""
    jd, td = dataclasses.asdict(jp), dataclasses.asdict(tp)
    own = {"rowlocal"} | ({"out_cap"} if td.get("rowlocal") else set())
    assert set(td) - own <= set(jd)
    assert {k: jd[k] for k in td if k not in own} == {
        k: v for k, v in td.items() if k not in own}


def assert_same_arrays(js, ts, names):
    for f in names:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_esc(name):
    ja, jb, ta, tb = operands(name)
    assert_same_csr(J.spgemm(ja, jb, method="esc"),
                    T.spgemm(ta, tb, method="esc"))


# the matrices whose chunked plan takes the row-local route (kernel K6);
# the circuit's hub rows and the power law's long rows need more shared
# memory than two of K6's blocks an SM hold, so those keep the stream
ROWLOCAL = sorted(set(MATRICES) - {"circuit", "powerlaw_small"})


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_chunked(name):
    """The plan and C against the reference's; on the row-local route the
    CPU runs K6's plain version and C is sized at pad_gentle(nnz(C)). K6's
    plain version on every matrix, routed or not, against the reference's
    C and scipy's."""
    ja, jb, ta, tb = operands(name)
    jp, tp = jc.make_chunked_plan(ja, jb), tc.make_chunked_plan(ta, tb)
    assert_same_plan(jp, tp)
    t = tc.spgemm_chunked(ta, tb, tp)
    want = jc.spgemm_chunked(ja, jb, jp)
    nnz = int(t.rowptr[-1])
    assert (tp.rowlocal is not None) == (name in ROWLOCAL)
    if tp.rowlocal is not None:
        assert tp.out_cap == pad_gentle(nnz) == t.capacity
    else:
        assert tp.out_cap == jp.out_cap
    assert_same_csr(want, t)
    assert_csr_equal(t, spgemm_reference(ta, tb), **F32_TOL)
    plain = rowlocal.rowlocal_esc_plain(ta, tb, out_cap=pad_gentle(nnz),
                                        max_run=tp.max_run)
    assert_same_csr(want, plain)
    assert_csr_equal(plain, spgemm_reference(ta, tb), **F32_TOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_chunked_stream(name):
    """The stream of the same plans (``rowlocal=False``): the reference's
    plan field for field, C equal to the reference's."""
    ja, jb, ta, tb = operands(name)
    jp = jc.make_chunked_plan(ja, jb)
    tp = tc.make_chunked_plan(ta, tb, rowlocal=False)
    assert tp.rowlocal is None
    assert_same_plan(jp, tp)
    assert tp.out_cap == jp.out_cap
    assert_same_csr(jc.spgemm_chunked(ja, jb, jp),
                    tc.spgemm_chunked(ta, tb, tp))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grouped(name):
    ja, jb, ta, tb = operands(name)
    js, ts = jg.make_grouped_plan(ja, jb), tg.make_grouped_plan(ta, tb)
    assert_same_plan(js.plan, ts.plan)
    assert_same_arrays(js, ts, ("slot0", "first_rank", "sorted_off",
                                "fill_end"))
    t = tg.spgemm_grouped(ta, tb, ts)
    assert_same_csr(jg.spgemm_grouped(ja, jb, js), t)
    assert_csr_equal(t, spgemm_reference(ta, tb), **F32_TOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tilepack(name):
    ja, jb, ta, tb = operands(name)
    js, ts = jt.make_tilepack_plan(ja, jb), tt.make_tilepack_plan(ta, tb)
    if js is None:  # long rows: both packages decline the regime
        assert ts is None
        return
    assert_same_plan(js.plan, ts.plan)
    assert_same_arrays(js, ts, ("slot0", "q", "first_rank"))
    t = tt.spgemm_tilepack(ta, tb, ts)
    assert_same_csr(jt.spgemm_tilepack(ja, jb, js), t)


def test_chunked_explicit_modes():
    """The aligned, mixed and wide expansions (picked by the plan only for
    some matrices) against scipy."""
    a = T.CSR.from_scipy(tgen.circuit(2048, seed=3), device="cpu")
    want = spgemm_reference(a, a)
    for kw in (dict(al=8), dict(al=8, al_min=3), dict(wide_min=64),
               dict(k=4)):
        plan = tc.make_chunked_plan(a, a, **kw)
        assert_csr_equal(tc.spgemm_chunked(a, a, plan), want, **F32_TOL)


def test_tilepack_runs_the_plain_kernel_on_cpu():
    _, _, ta, tb = operands("er_small")
    before = kernels.tile_sort_merge.launches
    c = T.spgemm(ta, tb, method="tilepack")
    assert kernels.tile_sort_merge.launches == before  # plain version
    assert_csr_equal(c, spgemm_reference(ta, tb), **F32_TOL)


@pytest.mark.parametrize("method", ["grouped", "chunked", "esc"])
def test_float64_against_x64_scipy(method):
    """Native float64 end to end, held against scipy in float64."""
    a = T.CSR.from_scipy(
        tgen.power_law(300, 300, alpha=1.9, max_deg=96, seed=6)
        .astype(np.float64), device="cpu")
    assert a.vals.dtype == torch.float64
    c = T.spgemm(a, a, method=method)
    assert c.vals.dtype == torch.float64
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-12, atol=1e-12)
