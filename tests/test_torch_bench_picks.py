"""The dispatcher's pick on the suite harness's three largest members
(400k-1M rows), port against reference; choose_method is host numpy, so
full size runs on the CPU, a few seconds a member in each package. The
other suite members are in tests/test_torch_api.py."""
import numpy as np
import pytest
import torch

import benchmark_spgemm_using_csr_tpu as J
from benchmark_spgemm_using_csr_tpu.utils import generators as jgen

import benchmark_spgemm_using_csr_tpu_torch as T

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["webbase_1m", "road_1m",
                                  "smallworld_400k"])
def test_choose_method_agrees_at_scale(name):
    a_sp = jgen.SUITE[name]()
    ja = J.CSR.from_scipy(a_sp)
    ta = T.CSR.from_numpy(np.asarray(ja.rowptr), np.asarray(ja.colidx),
                          np.asarray(ja.vals), ja.shape, device="cpu")
    want = J.choose_method(ja, ja)
    assert T.choose_method(ta, ta) == want == "grouped"
