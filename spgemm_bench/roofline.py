"""The least time of a sparse product on the card: read-once CSR bytes of
the operands and the result, and 2·nnzCt operations, at the H100 SXM's
data-sheet peaks.

Frozen copy of ``csr_bytes``, ``product_bound`` and ``csr_product_bound``
and of the ``H100_SXM`` row from
``benchmark_spgemm_using_csr_tpu_torch/utils/roofline.py`` at commit
b4c7115, cut to float32, so that a later change to the program cannot move
the yardstick. The count is of the work these inputs need, whatever method
computes the product.
"""
from __future__ import annotations

import dataclasses

INDEX_BYTES = 4
# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class Bound:
    """A product's least work: bytes through HBM and operations."""

    bytes_moved: float
    flops: float

    def __add__(self, other: "Bound") -> "Bound":
        return Bound(self.bytes_moved + other.bytes_moved,
                     self.flops + other.flops)

    def least_s(self) -> float:
        """The larger of bytes over the HBM rate and operations over the
        float32 rate."""
        return max(self.bytes_moved / HBM_BYTES_PER_S,
                   self.flops / F32_FLOPS)


def csr_bytes(m: int, nnz: int, itemsize: int = 4) -> int:
    """A CSR's exact bytes: rowptr, and colidx and values up to nnz."""
    return (m + 1) * INDEX_BYTES + nnz * (INDEX_BYTES + itemsize)


def product_bound(a_bytes: float, b_bytes: float, c_bytes: float,
                  products: int) -> Bound:
    """A and B read once each, C written once, 2·nnzCt operations."""
    return Bound(float(a_bytes + b_bytes + c_bytes), 2.0 * products)


def csr_product_bound(m: int, k: int, nnz_a: int, nnz_b: int, nnz_c: int,
                      products: int, itemsize: int = 4) -> Bound:
    """``product_bound`` of C (m x n) = A (m x k) @ B (k x n), all CSR."""
    return product_bound(csr_bytes(m, nnz_a, itemsize),
                         csr_bytes(k, nnz_b, itemsize),
                         csr_bytes(m, nnz_c, itemsize), products)
