"""How a caller drives the program: one module a traffic kind, named by the
``driver`` key of a traffic file, each with a class ``Driver``.

A driver makes its cell's inputs, builds what the program builds before
the window (plans, hierarchies, graphs), and gives the harness:

- ``setup()``: inputs, the program's set-up and the warm-up of every shape
  the window uses;
- ``prepare(i)``: call i's input, made outside the call's timer;
- ``call(x)``: the timed entry into the program; the harness synchronises;
- ``release()``: drops the program's state once the window has closed;
- ``outputs(out)``: the CSRs of one output as (rowptr, colidx, vals);
- ``reference(i, precision)``: the plain reference's CSRs for call i,
  worked out again from the benchmark's inputs (``reference/``);
- ``work()``: the canonical work of one call as a ``roofline.Bound``,
  from the reference's structures, so it is the same whatever route the
  program takes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import inputs, roofline
from ..reference import sparse


class Base:
    """What every driver shares: the cell's matrix, its value sets on the
    device, and the reference's copy of call i's operand."""

    def __init__(self, cell: dict, seed: int, device):
        self.cell = cell
        self.config = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.k = int(self.traffic.get("value_sets", 8))

    def make_matrix(self):
        """The matrix's host arrays (``self.host``), its structure as the
        program's CSR holds it, and its value sets on the device as the
        (k, capacity) rows of ``self.vals``, zero past nnz."""
        from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import (
            CSR, pad_bucket)

        rowptr, colidx, vals, shape = inputs.matrix(self.config)
        self.host = (rowptr, colidx, vals, shape)
        nnz = int(rowptr[-1])
        self.capacity = pad_bucket(nnz)
        col = np.zeros(self.capacity, np.int32)
        col[:nnz] = colidx[:nnz]
        a = CSR.from_numpy(rowptr, col, np.zeros(self.capacity, np.float32),
                           shape, device=self.device)
        self.structure = (a.rowptr, a.colidx, a.shape)
        base = torch.from_numpy(vals[:nnz].astype(np.float32)).to(
            self.device)
        self.vals = torch.zeros((self.k, self.capacity), dtype=torch.float32,
                                device=self.device)
        self.vals[:, :nnz] = inputs.value_sets(
            base, self.k, float(self.traffic["spread"]), self.seed)
        self.ref_rowptr = torch.from_numpy(rowptr.astype(np.int64)).to(
            self.device)
        self.ref_colidx = torch.from_numpy(colidx[:nnz].astype(np.int64)).to(
            self.device)

    def operand(self, k: int):
        """The program's CSR of value set k on the matrix's structure."""
        from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR

        rowptr, colidx, shape = self.structure
        return CSR(rowptr, colidx, self.vals[k], shape)

    def ref_operand(self, k: int) -> sparse.Mat:
        """The reference's copy of value set k on the matrix."""
        nnz = self.ref_colidx.shape[0]
        return sparse.from_arrays(self.ref_rowptr, self.ref_colidx,
                                  self.vals[k, :nnz], self.host[3],
                                  self.device)

    def work(self):
        """C = A·A: read-once CSR bytes of A (twice) and C, 2·nnzCt, as
        the reference counted them (every call's counts are the same)."""
        if not hasattr(self, "products"):
            self.reference(0)
        m, n = self.host[3]
        nnz = int(self.ref_colidx.shape[0])
        return roofline.csr_product_bound(m, n, nnz, nnz, self.nnz_c,
                                          self.products)

    @staticmethod
    def csr_parts(c) -> tuple:
        return (c.rowptr, c.colidx, c.vals)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
