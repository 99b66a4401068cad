"""The port's paths without a kernel of their own (bsr, dense, hash, fused,
out-of-core, SpMV/SpAdd/SpTRSV, BhSparse, the AMG / ILU0 solver path, the
distributed schedules over NCCL at world size 1 and the peak memory of bsr
and the out-of-core path) on a CUDA device, against the
scipy golden at the CLI's float32 tolerances (rtol 1e-4 / atol 1e-5).
These tests need the card and skip without one; the card has no jax, so
run them there without the repository's conftest:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.utils import generators
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("method,matrix", [
    ("bsr", lambda: generators.dense_rows(2048, 2048, nnz_per_row=96)),
    ("dense", lambda: generators.dense_rows(1024, 1024, nnz_per_row=128)),
])
def test_true_fp32_under_global_tf32(method, matrix):
    """bsr and dense hold the float32 tolerance with TF32 switched on
    globally, and leave the caller's setting as they found it."""
    need_card()
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    try:
        matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        a = T.CSR.from_scipy(matrix(), device="cuda")
        c = T.spgemm(a, a, method=method)
        assert_csr_equal(c, spgemm_reference(a, a), check_explicit_zeros=False,
                         **TOL)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = old


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bsr", "dense", "hash", "fused", "esc",
                                    "chunked", "binned"])
def test_methods_on_the_card(method):
    need_card()
    s = generators.banded(1024, 9, seed=2)
    a = T.CSR.from_scipy(s, device="cuda")
    c = T.spgemm(a, a, method=method)
    assert c.vals.is_cuda
    assert_csr_equal(c, spgemm_reference(a, a), check_explicit_zeros=False,
                     **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dense", "grouped", "chunked"])
def test_batched_on_the_card(method):
    need_card()
    a = T.CSR.from_scipy(generators.erdos_renyi(600, 600, 6.0, seed=3),
                         device="cuda")
    c = T.spgemm_batched(a, a, stream_budget=4000, method=method)
    assert_csr_equal(c, spgemm_reference(a, a), **TOL)


def peak_bytes(fn):
    """(result, peak device bytes above what was allocated before fn)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.mark.cuda
def test_host_mirror_keeps_no_freed_tensor():
    """A large CSR built on the card (its buffers registered in
    ``host_view``'s mirror), viewed through ``host_view`` and deleted: the
    allocated device memory returns to its baseline, without
    ``clear_host_mirror``."""
    import gc

    from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import host_view

    need_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    a = T.CSR.from_scipy(generators.SUITE["er_medium"](), device="cuda")
    c = T.spgemm(a, a, method="esc")
    for x in (a.rowptr, a.colidx, a.vals, c.rowptr, c.colidx, c.vals):
        host_view(x)
    assert torch.cuda.memory_allocated() > base + (8 << 20)
    del a, c, x
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.cuda
def test_bfloat16_methods_on_the_card():
    """bfloat16 through every method on the card (K1, K2 and K3 receive
    float32 upcasts), against scipy's float32 product of the rounded
    values at the CLI's bfloat16 tolerance."""
    from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import TOLERANCES

    need_card()
    s = generators.banded(1024, 9, seed=2)
    a = T.CSR.from_scipy(s, dtype=torch.bfloat16, device="cuda")
    want = spgemm_reference(a, a)
    for method in ("auto", "chunked", "grouped", "tilepack", "bsr", "dia",
                   "dense", "tiled", "fused", "esc", "binned", "hash"):
        c = T.spgemm(a, a, method=method)
        assert c.vals.dtype == torch.bfloat16 and c.vals.is_cuda, method
        assert_csr_equal(c, want, check_explicit_zeros=False,
                         **TOLERANCES["bfloat16"])


@pytest.mark.cuda
def test_bsr_peak_is_bounded_by_the_chunk_budget():
    """dense_rows_2k's ~65k block pairs would gather 4 GiB of B blocks at
    once; streamed, the peak is one chunk (BSR_CHUNK_BYTES of B blocks,
    with its A blocks and products) plus the output blocks, 256 bytes a
    pair of metadata and 64 MiB for cuBLAS's workspace."""
    from benchmark_spgemm_using_csr_tpu_torch.ops import bsr

    need_card()
    s = generators.SUITE["dense_rows_2k"]()
    a_b = T.BSR.from_scipy(s, (8, 128), device="cuda")
    b_b = T.BSR.from_scipy(s, (128, 128), device="cuda")
    plan = bsr.make_bsr_plan(a_b, b_b)
    per_pair = 128 * 128 * 4
    assert plan.pairs_cap * per_pair > 4 * bsr.BSR_CHUNK_BYTES
    c, peak = peak_bytes(lambda: bsr.bsr_spgemm(a_b, b_b, plan))
    chunk = bsr.BSR_CHUNK_BYTES // per_pair
    bound = (chunk * (8 * 128 + 128 * 128 + 8 * 128) * 4
             + (plan.out_blocks_cap + 1) * 8 * 128 * 4
             + 256 * plan.pairs_cap + (64 << 20))
    assert peak <= bound, (peak, bound)
    want = (s @ s).tocsr()
    want.eliminate_zeros()
    got = c.to_scipy().tocsr()
    got.eliminate_zeros()
    assert abs(got - want).max() <= 1e-4 * abs(want).max()


@pytest.mark.cuda
def test_batched_two_blocks_peak_below_in_core(monkeypatch):
    """Out of core in 2 dense blocks, each block's payload uploaded at its
    turn and its temporaries gone before the next: the peak is below the
    in-core dense path's on the same near-dense product."""
    import functools

    from benchmark_spgemm_using_csr_tpu_torch.ops import batched

    need_card()
    s = generators.dense_rows(4096, 4096, nnz_per_row=192, seed=1)
    a = T.CSR.from_scipy(s, device="cuda")
    monkeypatch.setattr(batched, "make_batched_plan", functools.partial(
        batched.make_batched_plan, dense_block_bytes=2048 * 4096 * 4))
    batched._plan_cache.clear()
    plan = batched._cached_plan(a, a, 64 * 1024 * 1024, "dense")
    assert len(plan.blocks) == 2
    ooc, peak_ooc = peak_bytes(
        lambda: T.spgemm_batched(a, a, method="dense"))
    inc, peak_inc = peak_bytes(lambda: T.spgemm(a, a, method="dense"))
    assert peak_ooc < peak_inc, (peak_ooc, peak_inc)
    # both keep C's symbolic structure: one entry's two products cancel,
    # exactly in scipy, to a rounding error under a fused multiply-add
    pat = s.copy()
    pat.data[:] = 1
    pat = (pat @ pat).tocsr()
    pat.sort_indices()
    want = (s.astype(np.float64) @ s.astype(np.float64)).toarray()
    for c in (ooc, inc):
        np.testing.assert_array_equal(c.rowptr.cpu().numpy(), pat.indptr)
        np.testing.assert_array_equal(c.colidx.cpu().numpy()[:pat.nnz],
                                      pat.indices)
        np.testing.assert_allclose(c.todense(), want, **TOL)
    batched._plan_cache.clear()


@pytest.mark.cuda
def test_solver_path_on_the_card():
    """AMG setup, both refresh routes, the V-cycle solve and ILU0-PCG
    (Jacobi and exact applies) on the card against scipy."""
    from benchmark_spgemm_using_csr_tpu_torch.models import amg, ilu0

    need_card()
    s = generators.poisson2d(32)
    b = np.random.default_rng(0).standard_normal(s.shape[0]).astype(
        np.float32)
    for smooth, route in ((True, "triple"), (False, "agg")):
        h = amg.build_hierarchy(s, smooth=smooth)
        assert h.levels[-1].a.vals.is_cuda
        s2 = s.copy()
        s2.data = s2.data * np.float32(1.5)
        h2 = amg.numeric_refresh(h, T.CSR.from_scipy(s2, device="cuda"))
        assert [k for k, _ in h._triple_plans[1:]] == [route] * (
            len(h.levels) - 1)
        cur = s2
        for lv, lv2 in zip(h.levels[1:], h2.levels[1:]):
            want = (lv.r.to_scipy() @ (cur @ lv.p.to_scipy())).tocsr()
            assert_csr_equal(lv2.a, want, rtol=1e-4, atol=1e-4)
            cur = want
    x, hist = amg.solve(s, b, tol=1e-4, max_iters=40)
    assert hist[-1] < 1e-4
    assert np.linalg.norm(b - s @ x) / np.linalg.norm(b) < 1e-3
    a = T.CSR.from_scipy(s, device="cuda")
    f = ilu0.ilu0(a, sweeps=20)
    assert ilu0.ilu0_residual_on_pattern(a, f) < 1e-4
    bt = torch.from_numpy(b).cuda()
    _, cg = ilu0.pcg(a, bt, None, tol=1e-5, max_iters=300)
    for precond in ("jacobi", "exact"):
        x, hist = ilu0.pcg(a, bt, f, tol=1e-5, max_iters=300, precond=precond)
        assert hist[-1] < 1e-5 and len(hist) < len(cg)
        assert np.linalg.norm(b - s @ x) / np.linalg.norm(b) < 1e-3


@pytest.mark.cuda
def test_ops_on_the_card():
    need_card()
    s = generators.power_law(500, 500, alpha=2.0, max_deg=80, seed=4)
    a = T.CSR.from_scipy(s, device="cuda")
    x = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    y = T.spmv(a, torch.from_numpy(x).cuda())
    np.testing.assert_allclose(y.cpu().numpy(), s @ x, rtol=1e-4, atol=1e-4)
    c = T.spadd(a, T.csr_transpose(a))
    assert_csr_equal(c, (s + s.T).tocsr(), **TOL)
    tri = (sp.tril(s, format="csr")
           + sp.identity(500, np.float32, format="csr") * 100.0).tocsr()
    xs = T.sptrsv(T.CSR.from_scipy(tri, device="cuda"),
                  torch.from_numpy(x).cuda())
    from scipy.sparse.linalg import spsolve_triangular

    np.testing.assert_allclose(xs.cpu().numpy(),
                               spsolve_triangular(tri, x, lower=True),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_bhsparse_reports_the_card():
    need_card()
    h = T.BhSparse()
    assert h.init_platform().startswith("cuda")
    s = generators.erdos_renyi(400, 400, 5.0, seed=5)
    h.init_data(400, 400, 400, s.indptr, s.indices, s.data,
                s.indptr, s.indices, s.data)
    h.spgemm()
    rowptr, colidx, vals = h.get_c()
    want = (s @ s).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(rowptr, want.indptr)
    np.testing.assert_array_equal(colidx, want.indices)
    np.testing.assert_allclose(vals, want.data, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["replicated", "ring", "halo"])
def test_dist_schedules_at_world_size_one_on_the_card(schedule):
    """dist_spgemm over a 1-rank NCCL group equals spgemm(auto) on the card
    (and scipy); a CPU tensor never travels on NCCL."""
    need_card()
    from benchmark_spgemm_using_csr_tpu_torch.parallel import bootstrap
    from benchmark_spgemm_using_csr_tpu_torch.parallel.dist import dist_spgemm
    from benchmark_spgemm_using_csr_tpu_torch.parallel.launch import free_port

    bootstrap.init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = bootstrap.global_mesh()
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        a = T.CSR.from_scipy(generators.power_law(
            2048, 2048, alpha=1.8, max_deg=256, seed=1), device="cuda")
        c = dist_spgemm(a, a, mesh, schedule=schedule)
        one = T.spgemm(a, a, method="auto")
        nnz = int(one.rowptr[-1])
        assert c.vals.is_cuda
        assert torch.equal(c.rowptr, one.rowptr)
        assert torch.equal(c.colidx[:nnz], one.colidx[:nnz])
        torch.testing.assert_close(c.vals[:nnz], one.vals[:nnz], **TOL)
        assert_csr_equal(c, spgemm_reference(a, a), **TOL)
        with pytest.raises(ValueError, match="cannot travel on nccl"):
            mesh.ring_shift(torch.zeros(4), 1)
    finally:
        bootstrap.shutdown()


@pytest.mark.cuda
def test_cli_mesh_past_the_cards_exits_nonzero():
    """--mesh one past the visible cards exits non-zero with the
    reference's message; it never falls back to the CPU."""
    need_card()
    import subprocess
    import sys

    n = torch.cuda.device_count()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark_spgemm_using_csr_tpu_torch",
         "suite:er_small", "--mesh", str(n + 1), "--json"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert f"need {n + 1} devices, have {n}" in out.stderr
