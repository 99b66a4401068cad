"""A synthetic circuit-class matrix: mostly 2-5 nonzeros a row plus a few
dense hub rows and hub columns.

Frozen copy of ``circuit`` from
``benchmark_spgemm_using_csr_tpu_torch/utils/generators.py`` at commit
b4c7115, so that a later change to the program cannot move the
benchmark's inputs. Only the return type differs: host arrays
``(rowptr, colidx, vals, shape)`` in canonical CSR order (sorted columns,
duplicates summed).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the size the benchmark's CPU tests cut a configuration of this generator
# to (``tests/conftest.make_small_root``)
SMALL_PARAMS = {"n": 2048, "seed": 0}


def generate(n: int, nnz_per_row: float = 3.0, n_hubs: int | None = None,
             hub_deg: int | None = None, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_hubs = n_hubs if n_hubs is not None else max(2, n // 2048)
    hub_deg = hub_deg if hub_deg is not None else min(n, 2048)
    lens = rng.poisson(nnz_per_row, size=n).clip(1, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = rng.integers(0, n, size=int(lens.sum()), dtype=np.int64)
    hubs = rng.choice(n, size=n_hubs, replace=False)
    hub_rows = np.repeat(hubs, hub_deg)
    hub_cols = rng.integers(0, n, size=n_hubs * hub_deg, dtype=np.int64)
    # rail columns: a slice of the short rows also touch a hub column
    n_rail = n // 16
    rail_rows = rng.integers(0, n, size=n_rail, dtype=np.int64)
    rail_cols = rng.choice(hubs, size=n_rail)
    diag = np.arange(n, dtype=np.int64)
    r = np.concatenate([rows, hub_rows, rail_rows, diag])
    c = np.concatenate([cols, hub_cols, rail_cols, diag])
    v = rng.standard_normal(r.size).astype(np.float32)
    mat = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat.indptr, mat.indices, mat.data, (n, n)
