"""The 5-point Laplacian on a k x k grid (PyAMG's gallery.poisson((k, k))).

Frozen copy of ``poisson2d`` from
``benchmark_spgemm_using_csr_tpu_torch/utils/generators.py`` at commit
b4c7115, so that a later change to the program cannot move the
benchmark's inputs. Only the return type differs: host arrays
``(rowptr, colidx, vals, shape)`` in canonical CSR order. The links cut
at the grid's row boundaries are not stored.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the size the benchmark's CPU tests cut a configuration of this generator
# to (``tests/conftest.make_small_root``)
SMALL_PARAMS = {"k": 24}


def generate(k: int):
    n = k * k
    main = np.full(n, 4.0, np.float32)
    offs = np.full(n - 1, -1.0, np.float32)
    # cut the east/west links across grid-row boundaries
    offs[np.arange(1, k) * k - 1] = 0.0
    ns = np.full(n - k, -1.0, np.float32)
    mat = sp.diags(
        [main, offs, offs, ns, ns], [0, 1, -1, k, -k], shape=(n, n),
        format="csr",
    ).astype(np.float32)
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat.indptr, mat.indices, mat.data, (n, n)
