"""The PyTorch port's CSR persistence (``CSR.save`` / ``load`` /
``from_dense`` / ``todense``) against the reference package's files and
arrays, and its retry with phase checkpoints (utils/retry.py, the
cases of the reference's tests/test_retry.py)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spgemm_using_csr_tpu import CSR as JCSR
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)
from benchmark_spgemm_using_csr_tpu_torch.utils.retry import Checkpointer, retry

torch.set_num_threads(2)

MATRICES = {
    "poisson2d_8": lambda: jgen.poisson2d(8).astype(np.float32),
    "er_rect": lambda: jgen.erdos_renyi(40, 60, 3.0, seed=1),
    "float64": lambda: jgen.erdos_renyi(30, 30, 4.0, seed=2).astype(np.float64),
    "empty": lambda: sp.csr_matrix((5, 7), dtype=np.float32),
}


def same_buffers(t, j):
    np.testing.assert_array_equal(t.rowptr.numpy(), np.asarray(j.rowptr))
    np.testing.assert_array_equal(t.colidx.numpy(), np.asarray(j.colidx))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    assert t.shape == j.shape


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_save_load_round_trips_across_packages(name, tmp_path):
    s = MATRICES[name]()
    t = T.CSR.from_scipy(s, device="cpu")
    t.save(str(tmp_path / "t"))  # npz appended, as np.savez does
    back = T.CSR.load(str(tmp_path / "t.npz"), device="cpu")
    for x, y in zip((back.rowptr, back.colidx, back.vals),
                    (t.rowptr, t.colidx, t.vals)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # a file of either package loads in the other
    j = JCSR.load(str(tmp_path / "t.npz"))
    if s.dtype == np.float32:  # the reference runs without x64
        same_buffers(t, j)
    j = JCSR.from_scipy(s.astype(np.float32))
    j.save(str(tmp_path / "j.npz"))
    same_buffers(T.CSR.load(str(tmp_path / "j.npz"), device="cpu"), j)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_dense_and_todense_equal_reference(name):
    d = MATRICES[name]().toarray().astype(np.float32)
    t = T.CSR.from_dense(d, device="cpu")
    j = JCSR.from_dense(d)
    same_buffers(t, j)
    np.testing.assert_array_equal(t.todense(), d)
    np.testing.assert_array_equal(t.todense(), j.todense())
    t16 = T.CSR.from_dense(d, capacity=max(int((d != 0).sum()), 1) + 16,
                           device="cpu")
    assert t16.capacity == max(int((d != 0).sum()), 1) + 16
    np.testing.assert_array_equal(t16.todense(), d)


def test_retry_succeeds_after_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42

    assert retry(flaky, attempts=3, backoff_s=0.01) == 42
    assert calls["n"] == 3


def test_retry_exhausts():
    def always():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        retry(always, attempts=2, backoff_s=0.01)


def test_checkpointer_phase_resume(tmp_path):
    a = T.CSR.from_scipy(jgen.poisson2d(12), device="cpu")
    ck = Checkpointer(str(tmp_path))
    calls = {"n": 0}

    def compute():
        calls["n"] += 1
        return T.spgemm(a, a)

    c1 = ck.phase("galerkin0", compute, device="cpu")
    assert calls["n"] == 1 and ck.done("galerkin0")
    c2 = ck.phase("galerkin0", compute, device="cpu")  # resumes from disk
    assert calls["n"] == 1
    want = spgemm_reference(a, a)
    assert_csr_equal(c1, want, rtol=1e-4, atol=1e-5)
    assert_csr_equal(c2, want, rtol=1e-4, atol=1e-5)
    assert c2.device == torch.device("cpu")


def test_checkpointer_retries_flaky_phase(tmp_path):
    a = T.CSR.from_scipy(jgen.poisson2d(8), device="cpu")
    ck = Checkpointer(str(tmp_path))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("preempted")
        return T.spgemm(a, a)

    c = ck.phase("lvl", flaky, device="cpu")
    assert calls["n"] == 2
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
