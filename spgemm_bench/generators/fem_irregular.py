"""A synthetic FEM-class matrix from an unstructured mesh ordering: a 3D
k x k x k node mesh with 27-point node connectivity, each off-diagonal
node block kept with probability ``fill``, node ids renumbered, then every
kept node block expanded to a dense ``dof`` x ``dof`` block.

The renumbering: with ``window`` None a uniform random permutation (no
locality); with an int, a locality-keeping sweep order, each node's
natural id jittered by up to ``window`` ids and the nodes ranked by that
key (a bandwidth near the natural one plus ``window`` nodes).

Frozen copy of ``fem`` and ``fem_irregular`` from
``benchmark_spgemm_using_csr_tpu_torch/utils/generators.py`` as they were
when the configuration ``fem_81k`` was added, so that a later change to
the program cannot move the benchmark's inputs. Only the return type differs: host arrays
``(rowptr, colidx, vals, shape)`` in canonical CSR order (sorted columns,
duplicates summed).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the size the benchmark's CPU tests cut a configuration of this generator
# to (``tests/conftest.make_small_root``): 3,993 rows, 50,886 nnz and
# 677,322 products, at most the 4,096 rows those tests hold; blocks kept
# sparsely enough that the dispatcher picks grouped, not dense, which the
# structure-reuse driver has no path for; the sweep window one mesh plane,
# as at the full size
SMALL_PARAMS = {"k": 11, "dof": 3, "fill": 0.15, "seed": 15, "window": 121}


def _fem(k: int, fill: float, seed: int) -> sp.csr_matrix:
    """The mesh in its natural node order, one unknown a node."""
    rng = np.random.default_rng(seed)
    nn = k * k * k
    idx = np.arange(nn, dtype=np.int64)
    x, y, z = idx // (k * k), (idx // k) % k, idx % k
    rows_l, cols_l = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = x + dx, y + dy, z + dz
                ok = (
                    (nx >= 0) & (nx < k) & (ny >= 0) & (ny < k)
                    & (nz >= 0) & (nz < k)
                )
                if (dx, dy, dz) != (0, 0, 0):  # diagonal blocks always kept
                    ok &= rng.random(nn) < fill
                rows_l.append(idx[ok])
                cols_l.append((nx * k * k + ny * k + nz)[ok])
    r = np.concatenate(rows_l)
    c = np.concatenate(cols_l)
    v = rng.standard_normal(r.size).astype(np.float32)
    mat = sp.coo_matrix((v, (r, c)), shape=(nn, nn)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def generate(k: int, dof: int = 3, fill: float = 0.7, seed: int = 0,
             window: int | None = None):
    base = _fem(k, fill, seed)
    rng = np.random.default_rng(seed + 0x5EED)
    nn = base.shape[0]
    if window is None:
        perm = rng.permutation(nn)
    else:
        perm = np.argsort(np.arange(nn) + window * rng.random(nn),
                          kind="stable")
    base = base[perm][:, perm].tocsr()
    if dof == 1:
        base.sort_indices()
        mat = base.astype(np.float32)
    else:
        # dof-expand after renumbering the nodes: dense dof x dof blocks
        # at irregular block positions
        coo = base.tocoo()
        di = np.arange(dof, dtype=np.int64)
        r = coo.row.astype(np.int64)[:, None, None] * dof + di[None, :, None]
        c = coo.col.astype(np.int64)[:, None, None] * dof + di[None, None, :]
        r, c = np.broadcast_arrays(r, c)
        r, c = r.reshape(-1).copy(), c.reshape(-1).copy()
        v = rng.standard_normal(r.size).astype(np.float32)
        n = nn * dof
        mat = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
        mat.sum_duplicates()
        mat.sort_indices()
    return mat.indptr, mat.indices, mat.data, mat.shape
