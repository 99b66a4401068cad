"""The port's large-scale demo (``scripts/demo_large.py``) at a small size
on the CPU, against the reference package's ``spgemm_batched`` on the same
matrix; its two checks of C, each shown to fail on a C with one value
changed or one entry dropped; the out-of-core plan's int32 guard and its
grouped fall back; the port's ``utils/oracle.random_csr`` against the
reference's."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.ops import batched as jbatched
from benchmark_spgemm_using_csr_tpu.utils import oracle as joracle

from benchmark_spgemm_using_csr_tpu_torch.ops import batched as tbatched
from benchmark_spgemm_using_csr_tpu_torch.scripts import demo_large
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR
from benchmark_spgemm_using_csr_tpu_torch.utils import oracle
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import TOLERANCES

torch.set_num_threads(2)

M, NNZ, SAMPLE = 4096, 40e3, 512


def budget_for(a_sp, blocks: int = 8) -> int:
    """A stream budget that cuts A @ A into at least ``blocks`` blocks."""
    return int(tbatched.row_products(a_sp, a_sp.indptr).sum()) // blocks


@pytest.fixture(scope="module", params=["chunked", "grouped"])
def demo(request):
    a_sp = demo_large.make_matrix(NNZ, M)
    out = demo_large.run(NNZ, budget_for(a_sp), SAMPLE, device="cpu", m=M,
                         method=request.param, say=lambda msg: None)
    assert out.record["method"] == request.param
    return out


def test_demo_equals_reference(demo):
    rec = demo.record
    assert rec["blocks"] >= 6 and not rec["fell_back"]
    assert rec["ok"] and rec["verified_sampled"] and rec["verified_vector"]
    want = jbatched.spgemm_batched(
        JCSR.from_scipy(demo.a), JCSR.from_scipy(demo.a),
        stream_budget=rec["budget"], as_scipy=True, method=rec["method"])
    got = demo.c
    assert got.nnz == rec["nnz_c"] == want.nnz
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, **TOLERANCES["float32"])


def sampled_rows():
    return np.sort(np.random.default_rng(0).choice(M, size=SAMPLE,
                                                   replace=False))


def spoiled(c_sp, how: str) -> sp.csr_matrix:
    """C with one entry of a sampled row changed by 1 or dropped: the
    entry whose term C_ij x_j of the vector check is largest."""
    x = np.random.default_rng(demo_large.VECTOR_SEED).standard_normal(M)
    row = int(sampled_rows()[0])
    lo, hi = int(c_sp.indptr[row]), int(c_sp.indptr[row + 1])
    assert hi > lo
    k = lo + int(np.argmax(np.abs(c_sp.data[lo:hi]
                                  * x[c_sp.indices[lo:hi]])))
    out = c_sp.copy()
    if how == "changed":
        out.data[k] += 1.0
        return out
    keep = np.ones(out.nnz, bool)
    keep[k] = False
    coo = out.tocoo()
    return sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                         shape=out.shape)


@pytest.mark.parametrize("how", ["changed", "dropped"])
@pytest.mark.parametrize("check", ["sampled", "vector"])
def test_checks_fail_on_a_spoiled_c(demo, check, how):
    a_sp, c_sp = demo.a, demo.c
    if check == "sampled":
        run = lambda c: demo_large.sampled_check(a_sp, c, sampled_rows())
    else:
        products = tbatched.row_products(a_sp, a_sp.indptr)
        run = lambda c: demo_large.vector_check(a_sp, c, products)
    assert run(c_sp)[0]
    ok, detail = run(spoiled(c_sp, how))
    assert not ok, detail


def small_csr():
    a_sp = demo_large.make_matrix(4e3, 512)
    return a_sp, CSR.from_scipy(a_sp, device="cpu")


def test_plan_refuses_nnz_c_past_int32(monkeypatch):
    """A block pattern counting 2^31 entries (faked: no such matrix is
    built) raises instead of wrapping C's int32 row pointer."""
    a_sp, a = small_csr()

    def huge(pat_a, pat_b, lo, hi):
        indptr = np.zeros(hi - lo + 1, np.int64)
        indptr[-1] = 2**31
        return indptr, np.zeros(0, np.int32)

    monkeypatch.setattr(tbatched, "_block_pattern", huge)
    with pytest.raises(ValueError, match=r"2,147,483,648.*2\^31 - 1"):
        tbatched.make_batched_plan(a, a, stream_budget=budget_for(a_sp),
                                   method="chunked")


def test_grouped_fall_back_runs_chunked(monkeypatch):
    """A grouped regime that rejects a block leaves the chunked plan, marked
    as a fall back, element for element."""
    a_sp, a = small_csr()
    budget = budget_for(a_sp)
    want = tbatched.make_batched_plan(a, a, stream_budget=budget,
                                      method="chunked")
    monkeypatch.setattr(tbatched, "_grouped_block_scheds",
                        lambda *args: None)
    got = tbatched.make_batched_plan(a, a, stream_budget=budget,
                                     method="grouped")
    assert got.method == "chunked" and got.fell_back and not want.fell_back
    assert got.grouped_scheds == ()
    assert got.chunked_plan == want.chunked_plan
    assert (got.blocks, got.nnz_c_blk, got.cap_c) == (
        want.blocks, want.nnz_c_blk, want.cap_c)
    np.testing.assert_array_equal(got.host_rowptr, want.host_rowptr)
    np.testing.assert_array_equal(got.host_colidx, want.host_colidx)


@pytest.mark.parametrize("args", [
    dict(m=64, n=64),
    dict(m=120, n=90, density=0.07, seed=4),
    dict(m=101, n=64, density=0.08, seed=3),
])
def test_random_csr_equals_reference(args):
    got = oracle.random_csr(**args, device="cpu")
    want = joracle.random_csr(**args)
    np.testing.assert_array_equal(got.rowptr.numpy(), np.asarray(want.rowptr))
    np.testing.assert_array_equal(got.colidx.numpy(), np.asarray(want.colidx))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))


def test_demo_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        demo_large.main(["--device", "cuda"])
