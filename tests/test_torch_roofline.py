"""The port's roofline (``utils/roofline``) against the reference package's
``utils/roofline``, and the port's profiling helpers, on the CPU.

The port prices every stage read-once at an H100's data sheet; its counts
equal the reference model's wherever the reference already counts
read-once (DIA's ``ideal_bytes``, the bsr and dense bytes), and its matrix
products are charged their flops once, not at the reference's 3 passes.
"""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.ops import bsr as jbsr
from benchmark_spgemm_using_csr_tpu.ops import dense as jdense
from benchmark_spgemm_using_csr_tpu.ops.dia import dia_spgemm as j_dia_spgemm
from benchmark_spgemm_using_csr_tpu.sparse.dia import DIA as JDIA
from benchmark_spgemm_using_csr_tpu.utils import roofline as jroof

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.ops import bsr as tbsr
from benchmark_spgemm_using_csr_tpu_torch.utils import generators
from benchmark_spgemm_using_csr_tpu_torch.utils import profiling
from benchmark_spgemm_using_csr_tpu_torch.utils import roofline as R

torch.set_num_threads(2)

# seeded matrices: uniform short rows, a skewed power law, a stencil
PLAN_MATRICES = {
    "er": lambda: generators.erdos_renyi(512, 512, 8.0, seed=3),
    "powerlaw": lambda: generators.power_law(1024, 1024, alpha=1.9,
                                             max_deg=300, seed=4),
    "poisson": lambda: generators.poisson2d(24),
}


def _csr(s, dtype=None):
    return T.CSR.from_scipy(s, dtype=dtype, device="cpu")


def _counts(a):
    s = a.to_scipy()
    c = (s @ s).tocsr()
    products = int(np.diff(s.indptr)[s.indices].sum())
    return s.nnz, c.nnz, products


@pytest.mark.parametrize("itemsize", [4, 8])
def test_dia_bytes_are_the_reference_ideal_bytes(itemsize):
    """Planes read once: the port's plane bytes are the reference model's
    ``ideal_bytes`` for the same (nd_a, nd_c), each package's DIA product
    on the same seeded band."""
    s = generators.banded(300, 7, seed=5).astype(
        np.float64 if itemsize == 8 else np.float32)
    jd = JDIA.from_scipy(s)
    jc = j_dia_spgemm(jd, jd)
    td = T.DIA.from_scipy(s, device="cpu")
    tc = T.dia_spgemm(td, td)
    nd_a, nd_c = td.data.shape[0], tc.data.shape[0]
    assert (nd_a, nd_c) == (jd.data.shape[0], jc.data.shape[0])
    want = jroof.dia_stage_models(nd_a, nd_c, n=s.shape[1],
                                  itemsize=itemsize)["plane_fma"]
    got = R.dia_stage_models(nd_a, nd_c, s.shape[1], itemsize)["plane_fma"]
    assert got.bytes_moved == want.ideal_bytes
    # the slots inside the matrix, as K3's bound counts them
    flops = R.dia_flops(td.offsets, td.offsets, s.shape[1], s.shape[1])
    assert flops <= got.flops == want.flops


def test_bsr_bytes_equal_reference_flops_a_third():
    """bsr: the same bytes as the reference model for each package's own
    block plan of the same matrix; the flops are the reference's divided
    by its 3 MXU passes."""
    s = generators.dense_rows(1024, 1024, nnz_per_row=64, seed=1)
    c = (s @ s).tocsr()
    nnzb_c = sp.bsr_matrix(c, blocksize=(8, 128)).indptr[-1]
    ja = J.BSR.from_scipy(s, (8, 128))
    jb = J.BSR.from_scipy(s, (128, 128))
    ta = T.BSR.from_scipy(s, (8, 128), device="cpu")
    tb = T.BSR.from_scipy(s, (128, 128), device="cpu")
    jplan, tplan = jbsr.make_bsr_plan(ja, jb), tbsr.make_bsr_plan(ta, tb)
    assert jplan.pairs_cap == tplan.pairs_cap
    args = (int(ja.rowptr[-1]), int(jb.rowptr[-1]), int(nnzb_c))
    want = jroof.bsr_stage_models(jplan.pairs_cap, *args)["block_matmul"]
    got = R.bsr_stage_models(tplan.pairs_cap, *args)["block_matmul"]
    assert got.bytes_moved == want.bytes_moved
    assert got.flops == want.flops / 3
    # the port's exact pair count never exceeds the plan's capacity
    pairs, nnzb_a, nnzb_b, nnzb_c2 = R._bsr_counts(_csr(s), _csr(s), _csr(c))
    assert (nnzb_a, nnzb_b, nnzb_c2) == args and pairs <= tplan.pairs_cap


def test_dense_bytes_equal_reference_flops_a_third():
    s = generators.dense_rows(256, 256, nnz_per_row=40, seed=2)
    ja = J.CSR.from_scipy(s)
    ta = _csr(s)
    jplan, tplan = jdense.make_dense_plan(ja, ja), T.make_dense_plan(ta, ta)
    assert jplan.nnz_c == tplan.nnz_c
    nnz_a = s.nnz
    want = jroof.dense_stage_models(256, 256, 256, nnz_a, jplan.nnz_c)
    got = R.dense_stage_models(256, 256, 256, nnz_a, tplan.nnz_c,
                               extract_mode=tplan.mode)
    for stage in ("scatter_in", "matmul"):
        assert got[stage].bytes_moved == want[stage].bytes_moved
    assert got["matmul"].flops == want["matmul"].flops / 3
    assert got["matmul"].matmul


def _plan_models(a, c, method):
    models, bound = R.spgemm_models(a, a, c, method)
    return models, bound


# tilepack's regime stops at 2048 padded products a row: not the skewed
# power law
PLAN_CASES = [(method, name) for method in ("chunked", "grouped", "tilepack")
              for name in sorted(PLAN_MATRICES)
              if (method, name) != ("tilepack", "powerlaw")]


@pytest.mark.parametrize("method,name", PLAN_CASES)
def test_plan_aware_stages_read_once(method, name):
    """No plan-aware stage moves more than one read and one write of its
    own stream (the plan's padded product slots, (key, value) each), the
    plan's tables and metadata, and the operands and C; and ``_bound`` is
    never above ``_total``."""
    a = _csr(PLAN_MATRICES[name]())
    c = T.spgemm(a, a, method="esc")
    nnz_a, nnz_c, products = _counts(a)
    models, bound = _plan_models(a, c, method)
    operands = 2 * R.csr_bytes(a.m, nnz_a) + R.csr_bytes(a.m, nnz_c)
    chip = R.H100_SXM
    if method == "chunked":
        # the plan takes the row-local route: K5's count and K6, each
        # product read once (column and value) and summed (two flops), at
        # or above the bound; then the stream's model on the same plan
        # without the route
        plan = T.make_chunked_plan(a, a)
        assert set(models) == {"symbolic_count", "rowlocal_esc"}
        assert models["rowlocal_esc"].flops == 2 * plan.slots == 2 * products
        for stage in models.values():
            assert 0 < stage.bytes_moved <= plan.slots * 12 + operands
        assert bound.sol_time_s(chip) <= sum(
            s.sol_time_s(chip) for s in models.values())
        plan = T.make_chunked_plan(a, a, rowlocal=False)
        models = R.chunked_stage_models(plan, nnz_a, nnz_a, a.m, nnz_c)
        stream = plan.prod_cap
        extra = (plan.abpad_cap + plan.bpad_cap) * 8 + 12 * (
            plan.chunks_cap + plan.nchunks_cap + plan.wchunks_cap)
        elem = 8 + 4
    elif method == "grouped":
        plan = T.make_grouped_plan(a, a).plan
        stream, elem = plan.prod_cap, 8
        extra = plan.abpad_cap * 8 + 16 * plan.s_cap
    else:
        plan = T.make_tilepack_plan(a, a).plan
        stream, elem = plan.t_cap * plan.w, 12
        extra = plan.abpad_cap * 8 + 8 * plan.s_cap + plan.t_cap * plan.wlr * 4
    for stage in models.values():
        assert 0 < stage.bytes_moved <= 2 * (stream * elem + extra) + operands
        assert stage.flops <= stream
    total = sum(s.sol_time_s(chip) for s in models.values())
    assert bound.sol_time_s(chip) <= total
    assert bound.flops == 2 * products
    # the reference's model charges log2 sort passes: the port's sort (or
    # kernel) stage is below it
    if method == "chunked":
        jp = J.make_chunked_plan(J.CSR.from_scipy(a.to_scipy()),
                                 J.CSR.from_scipy(a.to_scipy()))
        jm = jroof.chunked_stage_models(jp, nnz_a, nnz_a, a.m, nnz_c)
        assert models["sort"].bytes_moved < jm["sort"].bytes_moved


def test_generic_model_counts_the_stream_once():
    m = R.spgemm_stage_models(1000, 1000, 100, 5000, 3000)
    assert set(m) == {"symbolic", "expand", "sort", "compress"}
    assert m["sort"].bytes_moved == 2 * 5000 * 12
    assert m["expand"].flops + m["compress"].flops == 2 * 5000


def test_sol_fraction_is_none_for_a_cpu_time():
    a = _csr(PLAN_MATRICES["er"]())
    c = T.spgemm(a, a)
    models, bound = R.spgemm_models(a, a, c, "tilepack")
    rep = R.roofline_report(models, {"compact": 1e-3}, total_time_s=1e-2,
                            bound=bound, measured_on="cpu")
    assert rep["_total"]["chip"] == "H100 SXM"
    assert rep["_total"]["sol_fraction"] is None
    assert rep["_bound"]["sol_fraction"] is None
    assert rep["compact"]["sol_fraction"] is None
    assert rep["_bound"]["bound_by"] in ("bytes", "operations")
    for name in models:
        assert {"bytes", "flops", "sol_time_s"} <= set(rep[name])


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", R.H100_SXM),
    ("NVIDIA H100 SXM5 80GB", R.H100_SXM),
    ("NVIDIA H100 PCIe", R.H100_PCIE),
])
def test_card_table(name, want):
    assert R.chip_for_name(name) == want


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL",
                                  "TPU v5e"])
def test_unknown_card_raises(name):
    with pytest.raises(ValueError, match="no data-sheet row"):
        R.chip_for_name(name)


def test_report_fractions():
    """Stage times at twice their bound read 0.5, per stage, in ``_total``
    and in ``_bound``, for a time measured on a CUDA device."""
    chip = R.H100_SXM
    sm = R.spgemm_stage_models(1000, 1000, 100, 5000, 3000)
    times = {k: v.sol_time_s(chip) * 2 for k, v in sm.items()}
    total = sum(times.values())
    bound = R.product_bound(1e5, 1e5, 1e5, 5000)
    rep = R.roofline_report(sm, times, total_time_s=total, chip=chip,
                            bound=bound, measured_on="cuda")
    for k in sm:
        assert abs(rep[k]["sol_fraction"] - 0.5) < 1e-9
    assert abs(rep["_total"]["sol_fraction"] - 0.5) < 1e-9
    assert abs(rep["_bound"]["sol_fraction"]
               - bound.sol_time_s(chip) / total) < 1e-12


def test_rates_by_type():
    chip = R.H100_SXM
    assert chip.flops_per_s("float32", matmul=True) == 67e12
    assert chip.flops_per_s("float64") == 34e12
    assert chip.flops_per_s("float64", matmul=True) == 67e12
    assert chip.flops_per_s("bfloat16", matmul=True) == 989e12
    assert chip.flops_per_s("bfloat16") == 67e12  # formed in float32
    assert R.product_bound(0, 0, 0, 1, torch.bfloat16).matmul


def test_trace_writes_a_chrome_trace(tmp_path):
    a = _csr(PLAN_MATRICES["er"]())
    with profiling.trace(str(tmp_path), cuda=False) as prof:
        T.spgemm(a, a, method="esc")
    path = os.path.join(tmp_path, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sort" in e.get("name", "") for e in events)
    assert profiling.device_time_by_kernel(prof) == {}  # no card here
