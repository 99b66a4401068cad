"""bfloat16 values through every method of the port's ``spgemm``, its
dispatcher and its CLI, against the reference package's bfloat16 results
on the CPU.

Structures equal the reference's exactly; values agree with scipy's
float32 product of the bfloat16-rounded inputs at the CLI's bfloat16
tolerance (rtol 2e-2 / atol 1e-2). The port forms and sums every
bfloat16 product in float32 and rounds C once; the reference does the same
on chunked, grouped, tilepack, tiled and dense (values bit-equal here),
and sums in bfloat16 on esc, binned, fused and hash.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch import cli
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    TOLERANCES,
    assert_csr_equal,
    spgemm_reference,
)

torch.set_num_threads(2)

BF16 = TOLERANCES["bfloat16"]
METHODS = ("chunked", "grouped", "tilepack", "bsr", "dia", "dense", "tiled",
           "fused", "esc", "binned", "hash")
# the reference package cannot run these in bfloat16: both convert through
# scipy, which has no bfloat16 (bsr: "Output dtype not compatible with
# inputs"; dia: "scipy.sparse does not support dtype bfloat16")
REFERENCE_FAILS = ("bsr", "dia")
# the reference forms and sums products in float32 on these, as the port
# does: values bit-equal
BIT_EQUAL = ("chunked", "grouped", "tilepack", "tiled", "dense")


def pair(s):
    """The same bfloat16 matrix in both packages."""
    ja = J.CSR.from_scipy(s, dtype=jnp.bfloat16)
    ta = T.CSR.from_numpy(np.asarray(ja.rowptr), np.asarray(ja.colidx),
                          np.asarray(ja.vals).astype(np.float32), ja.shape,
                          device="cpu", dtype=torch.bfloat16)
    return ja, ta


def banded():
    return jgen.banded(256, 9, seed=2)


@pytest.mark.parametrize("method", METHODS)
def test_method_against_reference(method):
    ja, ta = pair(banded())
    tc = T.spgemm(ta, ta, method=method)
    assert tc.vals.dtype == torch.bfloat16
    assert_csr_equal(tc, spgemm_reference(ta, ta),
                     check_explicit_zeros=method not in ("bsr", "dia"), **BF16)
    if method in REFERENCE_FAILS:
        with pytest.raises(ValueError):
            J.spgemm(ja, ja, method=method)
        return
    jc = J.spgemm(ja, ja, method=method)
    nnz = int(np.asarray(jc.rowptr)[-1])
    np.testing.assert_array_equal(tc.rowptr.numpy(), np.asarray(jc.rowptr))
    np.testing.assert_array_equal(tc.colidx.numpy()[:nnz],
                                  np.asarray(jc.colidx)[:nnz])
    jv = np.asarray(jc.vals)[:nnz].astype(np.float32)
    tv = tc.vals.float().numpy()[:nnz]
    if method in BIT_EQUAL:
        np.testing.assert_array_equal(tv, jv)
    else:
        # the reference's bfloat16 sums stray further from the golden (up
        # to 0.125 here, past the tolerance); the port's float32 sums are
        # never further from it than the reference's
        want = spgemm_reference(ta, ta).toarray()
        rows = np.repeat(np.arange(ta.m), np.diff(tc.rowptr.numpy()))
        cols = tc.colidx.numpy()[:nnz]
        assert (np.abs(tv - want[rows, cols]).max()
                <= np.abs(jv - want[rows, cols]).max())


# shapes off the 128 grid, so that the dispatcher cannot take bsr (which
# the reference cannot run in bfloat16): its chunked, tilepack and grouped
AUTO = {
    "er": lambda: jgen.erdos_renyi(300, 300, 8.0, seed=1),
    "powerlaw": lambda: jgen.power_law(600, 600, alpha=2.0, max_deg=60,
                                       seed=4),
    "circuit": lambda: jgen.circuit(1500, seed=3),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_auto_same_csr_as_reference(name):
    ja, ta = pair(AUTO[name]())
    assert T.choose_method(ta, ta) == J.choose_method(ja, ja)
    jc = J.spgemm(ja, ja, method="auto")
    tc = T.spgemm(ta, ta, method="auto")
    np.testing.assert_array_equal(tc.rowptr.numpy(), np.asarray(jc.rowptr))
    np.testing.assert_array_equal(tc.colidx.numpy(), np.asarray(jc.colidx))
    np.testing.assert_allclose(tc.vals.float().numpy(),
                               np.asarray(jc.vals).astype(np.float32), **BF16)
    # scipy drops sums that cancel to exactly 0, which bfloat16's 8-bit
    # mantissas make common; C keeps them, so compare pruned structures
    assert_csr_equal(tc, spgemm_reference(ta, ta), check_explicit_zeros=False,
                     **BF16)


@pytest.mark.parametrize("name", ["er_small", "powerlaw_small",
                                  "poisson2d_64", "dense_rows_2k",
                                  "stencil27_32", "hubrows_32k", "er_medium",
                                  "powerlaw_medium", "circuit_64k",
                                  "mc2depi_524k"])
def test_choose_method_agrees(name):
    """The dispatcher's bfloat16 picks are the reference's (its dense, hash
    and dia estimates read a 2-byte itemsize; grouped admits bfloat16), on
    small suite matrices and on the five ``chip_smoke.py`` runs."""
    ja, ta = pair(jgen.SUITE[name]())
    assert T.choose_method(ta, ta) == J.choose_method(ja, ja)


def test_from_scipy_rounds_and_to_scipy_upcasts():
    s = jgen.erdos_renyi(64, 64, 4.0, seed=7)
    a = T.CSR.from_scipy(s, dtype=torch.bfloat16, device="cpu")
    assert a.vals.dtype == torch.bfloat16
    back = a.to_scipy()
    assert back.dtype == np.float32
    want = torch.from_numpy(s.data).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(back.data, want)
    np.testing.assert_array_equal(back.indices, s.indices)


def test_cli_bfloat16(capsys):
    rc = cli.main(["gen:er:128", "--device", "cpu", "--dtype", "bfloat16",
                   "--json", "--runs", "1", "--warmup", "0"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert record["dtype"] == "bfloat16" and record["verified"] is True


@pytest.mark.parametrize("spec,method", [("gen:er:128", "bsr"),
                                         ("gen:poisson2d:24", "dia"),
                                         ("gen:powerlaw:600", None)])
def test_cli_roofline(capsys, spec, method):
    """``--roofline``: the stages of the method that ran (auto resolved),
    each with bytes, flops and sol_time_s, ``_total`` and ``_bound``, and no
    share for a CPU time."""
    rc = cli.main([spec, "--device", "cpu", "--roofline", "--json",
                   "--runs", "1", "--warmup", "0"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    if method:
        assert record["roofline_method"] == method
    rep = record["roofline"]
    stages = [k for k in rep if not k.startswith("_")]
    assert stages
    if record["roofline_method"] in ("dense", "dia"):
        assert "sort" not in stages  # never the generic ESC model
    for k in stages:
        assert {"bytes", "flops", "sol_time_s"} <= set(rep[k])
    assert rep["_bound"]["flops"] == 2 * record["nnz_ct"]
    assert rep["_bound"]["sol_fraction"] is None
    assert rep["_total"]["sol_fraction"] is None


def test_cli_mesh_not_ported(capsys):
    """--mesh is ported: bfloat16 over two gloo ranks (the ring carries
    the values as float32 bits) runs to a verified record."""
    rc = cli.main(["gen:er:128", "--device", "cpu", "--mesh", "2",
                   "--schedule", "ring", "--dtype", "bfloat16", "--json",
                   "--runs", "1", "--warmup", "0"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert (record["method"], record["dtype"]) == ("dist/ringx2", "bfloat16")
