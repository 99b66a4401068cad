"""Speed-of-light accounting for SpGEMM on the card: the least bytes and
operations each stage of a product must move and do, priced at an NVIDIA
H100's data-sheet peaks, and the share of that least time a measured
device time reaches.

The counterpart of the reference package's ``utils/roofline.py``, with the
same names. What differs, by design:

- every stage is priced read-once: it reads its inputs once and writes its
  outputs once. There are no log2 sort passes, no gather-descriptor or
  tile-lane ceilings and no fixed wall cost (those were TPU measurements);
- operations are priced at the rate of the type the port computes in:
  IEEE float32 outside the tensor cores (``ops/dense.ieee_fp32`` forces it
  for matrix products too, and bfloat16 products are formed in float32),
  float64 matrix products on the tensor cores and other float64 work
  outside them, so a matrix product is charged its 2·m·k·n flops once;
- DIA is priced at its read-once planes, not at the gather form's re-reads;
- ``roofline_report`` adds ``_bound``: the least time of the whole
  product, whatever method runs it (A and B read once, C written once,
  2·nnzCt flops at the value type's fastest rate; ``product_bound``).

A share (``sol_fraction``) exists only for a time measured on a CUDA
device; for a CPU time the report gives the counts and bound times
against the named card, with ``sol_fraction`` None.
"""
from __future__ import annotations

import dataclasses

INDEX_BYTES = 4


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Data-sheet peaks of one card (dense rates, no sparsity), at its full
    power limit."""

    name: str
    hbm_bytes_per_s: float
    f32_flops: float  # float32 outside the tensor cores
    f64_flops: float  # float64 outside the tensor cores
    f64_tensor_flops: float
    bf16_tensor_flops: float

    def flops_per_s(self, dtype: str = "float32", matmul: bool = False) -> float:
        """The rate of operations in ``dtype``: matrix products
        (``matmul``) in float64 or bfloat16 on the tensor cores, everything
        else, and every float32 product, outside them (IEEE float32: TF32
        would change the results)."""
        dtype = _dtype_name(dtype)
        if dtype == "float64":
            return self.f64_tensor_flops if matmul else self.f64_flops
        if dtype in ("bfloat16", "float16") and matmul:
            return self.bf16_tensor_flops
        return self.f32_flops


# NVIDIA H100 data sheet (dense, without sparsity)
H100_SXM = ChipSpec("H100 SXM", hbm_bytes_per_s=3.35e12, f32_flops=67e12,
                    f64_flops=34e12, f64_tensor_flops=67e12,
                    bf16_tensor_flops=989e12)
H100_PCIE = ChipSpec("H100 PCIe", hbm_bytes_per_s=2.0e12, f32_flops=51e12,
                     f64_flops=26e12, f64_tensor_flops=51e12,
                     bf16_tensor_flops=756e12)


def chip_for_name(name: str) -> ChipSpec:
    """The data-sheet row of a card named as
    ``torch.cuda.get_device_properties(...).name`` names it ("NVIDIA H100
    80GB HBM3" is the SXM part). A card outside the table raises."""
    if "H100" in name:
        if "PCIe" in name:
            return H100_PCIE
        if "SXM" in name or "HBM3" in name:
            return H100_SXM
    raise ValueError(f"no data-sheet row for the card {name!r} "
                     f"(have {H100_SXM.name}, {H100_PCIE.name})")


def chip_spec(device=None) -> ChipSpec:
    """The data-sheet row of the card a CUDA ``device`` is (default: the
    current one). A CPU device has no card of its own: its reports are
    priced against the H100 SXM, the card the port is built for, and say
    so in their ``chip`` field."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return H100_SXM
    return chip_for_name(torch.cuda.get_device_properties(device).name)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class StageModel:
    """One stage's least work: the bytes it must move through HBM and the
    operations it must do, in ``dtype`` (``matmul``: as matrix products)."""

    name: str
    bytes_moved: float
    flops: float
    dtype: str = "float32"
    matmul: bool = False

    def times_s(self, chip: ChipSpec) -> tuple[float, float]:
        """(bytes over the HBM rate, operations over their rate)."""
        return (self.bytes_moved / chip.hbm_bytes_per_s,
                self.flops / chip.flops_per_s(self.dtype, self.matmul))

    def sol_time_s(self, chip: ChipSpec) -> float:
        """Speed-of-light time: the larger of the two."""
        return max(self.times_s(chip))

    def bound_by(self, chip: ChipSpec) -> str:
        t_bytes, t_ops = self.times_s(chip)
        return "bytes" if t_bytes >= t_ops else "operations"


# ---- byte counts -------------------------------------------------------------


def csr_bytes(m: int, nnz: int, itemsize: int = 4) -> int:
    """A CSR's exact bytes: rowptr, and colidx and values up to nnz."""
    return (m + 1) * INDEX_BYTES + nnz * (INDEX_BYTES + itemsize)


def _acc(itemsize: int) -> tuple[int, str]:
    """(bytes, type) of the values the port computes in: float64 stays
    float64; float32, bfloat16 and float16 are computed in float32."""
    return (8, "float64") if itemsize == 8 else (4, "float32")


def _key_bytes(m: int, n: int) -> int:
    """The least key of a (row, col) pair: 4 bytes when it packs into 32
    bits, else 8."""
    rbits = max(int(max(m - 1, 1)).bit_length(), 1)
    cbits = max(int(max(n - 1, 1)).bit_length(), 1)
    return 4 if rbits + cbits <= 32 else 8


def product_bound(a_bytes: float, b_bytes: float, c_bytes: float,
                  products: int, dtype: str = "float32") -> StageModel:
    """The whole product's least work, whatever method runs it: A and B read
    once each in the form the timed window receives them, C written once,
    2·nnzCt flops at the value type's fastest rate."""
    dtype = _dtype_name(dtype)
    return StageModel("_bound", bytes_moved=float(a_bytes + b_bytes + c_bytes),
                      flops=2.0 * products, dtype=dtype,
                      matmul=dtype in ("bfloat16", "float16", "float64"))


def csr_product_bound(m: int, k: int, nnz_a: int, nnz_b: int, nnz_c: int,
                      products: int, itemsize: int = 4,
                      dtype: str = "float32") -> StageModel:
    """``product_bound`` of C (m x n) = A (m x k) @ B (k x n), all CSR."""
    return product_bound(csr_bytes(m, nnz_a, itemsize),
                         csr_bytes(k, nnz_b, itemsize),
                         csr_bytes(m, nnz_c, itemsize), products, dtype)


# ---- stage models --------------------------------------------------------------


def spgemm_stage_models(
    nnz_a: int,
    nnz_b: int,
    m: int,
    total_products: int,
    nnz_c: int,
    itemsize: int = 4,
    index_size: int = INDEX_BYTES,
) -> dict[str, StageModel]:
    """The generic expand-sort-compress pipeline, each stage read-once: the
    product stream of (row, col, value) triples is written by the
    expansion, read and written once by the sort, and read once by the
    compression, which writes C. For the methods with no plan of their
    own (esc, tiled, binned, fused, hash)."""
    f = max(int(total_products), 1)
    acc, acc_t = _acc(itemsize)
    triple = 2 * index_size + acc
    a_bytes = csr_bytes(m, nnz_a, itemsize)
    b_bytes = csr_bytes(m, nnz_b, itemsize)
    return {
        # A's structure and B's row pointers in, per-row product counts out
        "symbolic": StageModel(
            "symbolic",
            bytes_moved=(m + 1) * index_size + nnz_a * index_size
            + (m + 1) * index_size + (m + 1) * index_size,
            flops=float(nnz_a), dtype=acc_t,
        ),
        "expand": StageModel(
            "expand", bytes_moved=a_bytes + b_bytes + f * triple,
            flops=float(f), dtype=acc_t,
        ),
        "sort": StageModel("sort", bytes_moved=2.0 * f * triple, flops=0.0),
        "compress": StageModel(
            "compress",
            bytes_moved=f * triple + csr_bytes(m, nnz_c, itemsize),
            flops=float(f), dtype=acc_t,
        ),
    }


def chunked_stage_models(
    plan,
    nnz_a: int,
    nnz_b: int,
    m: int,
    nnz_c: int,
    itemsize: int = 4,
    n: int | None = None,
) -> dict[str, StageModel]:
    """ops/chunked.spgemm_chunked under its ``ChunkedPlan``: the padded
    product stream of ``plan.prod_cap`` slots, (key, value) pairs, each
    stage read-once. The metadata stage writes three constants a chunk
    (B position, remaining length, A value); the aligned and wide tables
    are written once and read once. On the row-local route, K5's count
    (A's columns, a B column a product, two words a row) and K6 (A, a B
    column and value a product, C), each read-once."""
    n = m if n is None else n
    acc, acc_t = _acc(itemsize)
    if plan.rowlocal is not None:
        products = plan.rowlocal.slots
        return {
            "symbolic_count": StageModel(
                "symbolic_count",
                bytes_moved=INDEX_BYTES * (nnz_a + products + 2 * m),
                flops=0.0,
            ),
            "rowlocal_esc": StageModel(
                "rowlocal_esc",
                bytes_moved=csr_bytes(m, nnz_a, itemsize)
                + products * (INDEX_BYTES + itemsize)
                + csr_bytes(m, nnz_c, itemsize),
                flops=2.0 * products, dtype=acc_t,
            ),
        }
    stream = plan.prod_cap
    elem = _key_bytes(m, n) + acc
    chunks = plan.chunks_cap + plan.nchunks_cap + plan.wchunks_cap
    meta_out = 3 * 4 * chunks
    tables = (plan.abpad_cap + plan.bpad_cap) * (INDEX_BYTES + acc)
    return {
        "metadata": StageModel(
            "metadata",
            bytes_moved=csr_bytes(m, nnz_a, itemsize) + (m + 1) * INDEX_BYTES
            + meta_out,
            flops=0.0,
        ),
        "expand": StageModel(
            "expand",
            bytes_moved=meta_out + nnz_b * (INDEX_BYTES + itemsize)
            + 2.0 * tables + stream * elem,
            flops=float(stream), dtype=acc_t,
        ),
        "sort": StageModel("sort", bytes_moved=2.0 * stream * elem, flops=0.0),
        "runsum": StageModel(
            "runsum", bytes_moved=2.0 * stream * elem, flops=float(stream),
            dtype=acc_t,
        ),
        "compact": StageModel(
            "compact",
            bytes_moved=stream * elem + csr_bytes(m, nnz_c, itemsize),
            flops=0.0,
        ),
    }


def tilepack_stage_models(
    plan,
    nnz_a: int,
    nnz_b: int,
    m: int,
    nnz_c: int,
    itemsize: int = 4,
) -> dict[str, StageModel]:
    """ops/tilepack.spgemm_tilepack under its ``TilePackPlan``: t_cap * w
    lanes of (int32 key, float32 value); the kernel stage is K1's own
    traffic (key and value read; key, value and position written; the
    per-local-row counts), each stage read-once."""
    lanes = plan.t_cap * plan.w
    slots = plan.s_cap
    acc, acc_t = _acc(itemsize)
    elem = INDEX_BYTES + acc
    counts = plan.t_cap * max(plan.wlr_eff, 1) * INDEX_BYTES
    kernel = tile_sort_merge_model(plan.t_cap, plan.w, max(plan.wlr_eff, 1))
    return {
        "metadata": StageModel(
            "metadata",
            bytes_moved=csr_bytes(m, nnz_a, itemsize) + (m + 1) * INDEX_BYTES
            + 2 * 4 * slots,
            flops=0.0,
        ),
        "expand": StageModel(
            "expand",
            bytes_moved=2 * 4 * slots + nnz_b * (INDEX_BYTES + itemsize)
            + 2.0 * plan.abpad_cap * (INDEX_BYTES + acc) + lanes * elem,
            flops=float(lanes), dtype=acc_t,
        ),
        "tile_sort_merge": kernel,
        "compact": StageModel(
            "compact",
            bytes_moved=lanes * (elem + INDEX_BYTES) + counts
            + csr_bytes(m, nnz_c, itemsize),
            flops=0.0,
        ),
    }


def grouped_stage_models(
    plan,
    nnz_a: int,
    nnz_b: int,
    m: int,
    nnz_c: int,
    itemsize: int = 4,
) -> dict[str, StageModel]:
    """ops/grouped.spgemm_grouped under its ``GroupedPlan``: the padded
    stream of ``plan.prod_cap`` (32-bit key, value) pairs, sorted within
    groups, each stage read-once."""
    stream = plan.prod_cap
    acc, acc_t = _acc(itemsize)
    elem = INDEX_BYTES + acc
    meta_out = 2 * 8 * plan.s_cap  # B position and A entry id a slot
    return {
        "metadata": StageModel(
            "metadata",
            bytes_moved=csr_bytes(m, nnz_a, itemsize) + (m + 1) * INDEX_BYTES
            + meta_out,
            flops=0.0,
        ),
        "expand": StageModel(
            "expand",
            bytes_moved=meta_out + nnz_b * (INDEX_BYTES + itemsize)
            + 2.0 * plan.abpad_cap * (INDEX_BYTES + acc) + stream * elem,
            flops=float(stream), dtype=acc_t,
        ),
        "sort": StageModel("sort", bytes_moved=2.0 * stream * elem, flops=0.0),
        "runsum": StageModel(
            "runsum", bytes_moved=2.0 * stream * elem, flops=float(stream),
            dtype=acc_t,
        ),
        "compact": StageModel(
            "compact",
            bytes_moved=stream * elem + csr_bytes(m, nnz_c, itemsize),
            flops=0.0,
        ),
    }


def dia_flops(a_offsets, b_offsets, k: int, n: int) -> int:
    """2 flops per term slot of C = A @ B on DIA planes (A: k columns, B: n
    columns) whose A read falls inside A's columns: the term (d1, d2) runs
    over j in [max(0, d2), min(n, k + d2))."""
    n_a = len(a_offsets)
    return 2 * n_a * sum(max(0, min(n, k + d2) - max(0, d2))
                         for d2 in b_offsets)


def dia_stage_models(
    nd_a: int, nd_c: int, n: int, itemsize: int = 4, *,
    nd_b: int | None = None, flops: float | None = None,
    nnz_c: int | None = None,
) -> dict[str, StageModel]:
    """DIA SpGEMM (ops/dia.py; kernel K3 on the card): every plane of A and
    B read once and every C plane written once (the reference model's
    ``ideal_bytes``). ``flops`` defaults to 2 per term slot,
    2 · nd_a · nd_b · n; ``dia_flops`` counts the slots inside the matrix.
    With ``nnz_c``, a second stage reads C's planes once and writes C's
    CSR (``DIA.to_csr``), as the port's numeric phase ends."""
    nd_b = nd_a if nd_b is None else nd_b
    acc, acc_t = _acc(itemsize)
    if flops is None:
        flops = 2.0 * nd_a * nd_b * n
    models = {
        "plane_fma": StageModel(
            "plane_fma", bytes_moved=float((nd_a + nd_b + nd_c) * n * acc),
            flops=float(flops), dtype=acc_t,
        ),
    }
    if nnz_c is not None:
        models["to_csr"] = StageModel(
            "to_csr", bytes_moved=float(nd_c * n * acc
                                        + csr_bytes(n, nnz_c, itemsize)),
            flops=0.0)
    return models


def bsr_stage_models(
    pairs: int,
    nnzb_a: int,
    nnzb_b: int,
    nnzb_c: int,
    block_shape: tuple[int, int] = (8, 128),
    bn: int = 128,
    itemsize: int = 4,
) -> dict[str, StageModel]:
    """BSR SpGEMM (ops/bsr.py): each distinct block read or written once
    (the reference model's bytes), 2·bm·bk·bn flops a block pair, charged
    once, as matrix products."""
    bm, bk = block_shape
    acc, acc_t = _acc(itemsize)
    return {
        "block_matmul": StageModel(
            "block_matmul",
            bytes_moved=float((nnzb_a * bm * bk + nnzb_b * bk * bn
                               + nnzb_c * bm * bn) * acc),
            flops=2.0 * pairs * bm * bk * bn, dtype=acc_t, matmul=True,
        ),
    }


def dense_stage_models(
    m: int, k: int, n: int, nnz_a: int, nnz_c: int, itemsize: int = 4,
    extract_mode: str | None = None,
) -> dict[str, StageModel]:
    """Dense SpGEMM (ops/dense.py): the scatter of A's (and, A @ A, B's)
    entries into a dense operand, one matmul of 2·m·k·n flops charged once,
    and the extraction of C's nnz_c values (reading the dense C once, and
    the plan's per-slot arrays of ``extract_mode``: 'shift' 5 bytes a
    slot, 'scan' 8, 'identity' none)."""
    acc, acc_t = _acc(itemsize)
    per_slot = {"shift": 5, "scan": 8}.get(extract_mode, 0)
    return {
        "scatter_in": StageModel(
            "scatter_in",
            bytes_moved=2 * nnz_a * (2 * INDEX_BYTES + itemsize) + m * k * acc,
            flops=0.0,
        ),
        "matmul": StageModel(
            "matmul", bytes_moved=float((m * k + k * n + m * n) * acc),
            flops=2.0 * m * k * n, dtype=acc_t, matmul=True,
        ),
        "extract": StageModel(
            "extract",
            bytes_moved=float(m * n * (acc + per_slot) + nnz_c * itemsize),
            flops=0.0,
        ),
    }


def batched_dense_stage_models(
    plan, kdim: int, n: int, nnz_a: int, itemsize: int = 4
) -> dict[str, StageModel]:
    """The out-of-core dense plan (ops/batched.py, ``method == 'dense'``):
    B densified once; per row block an A block densified, one matmul of
    2·rows_cap·kdim·n flops and its C block's extraction; then the value
    assembly. The payloads' uploads cross PCIe, not HBM, and are not
    counted."""
    acc, acc_t = _acc(itemsize)
    nb = len(plan.blocks)
    slots = plan.rows_cap * n
    per_slot = {"shift": 5, "gather": 0, "full": 0}
    blocks = 0.0
    for i in range(nb):
        mode = plan.flat_c[i][0] if plan.flat_c else "gather"
        blocks += (plan.rows_cap * kdim + kdim * n + slots) * acc  # matmul
        blocks += slots * (acc + per_slot.get(mode, 0))  # extraction
        blocks += plan.nnz_c_blk[i] * (itemsize + (8 if mode == "gather"
                                                   else 0))
    return {
        "densify_b": StageModel(
            "densify_b",
            bytes_moved=float(nnz_a * (2 * INDEX_BYTES + itemsize)
                              + kdim * n * acc),
            flops=0.0,
        ),
        "blocks": StageModel(
            "blocks", bytes_moved=blocks,
            flops=2.0 * nb * plan.rows_cap * kdim * n, dtype=acc_t,
            matmul=True,
        ),
        "assembly": StageModel(
            "assembly", bytes_moved=2.0 * plan.nnz_c * itemsize, flops=0.0,
        ),
    }


def tile_sort_merge_model(r: int, w: int, wlr: int) -> StageModel:
    """Kernel K1 on (r, w) tiles: int32 key and float32 value read; key,
    value and position written (20 bytes a lane), and the (r, wlr)
    counts."""
    return StageModel("tile_sort_merge",
                      bytes_moved=float(r * w * 20 + r * wlr * INDEX_BYTES),
                      flops=float(r * w))


def bin_sort_compress_model(r: int, w: int, itemsize: int = 4) -> StageModel:
    """Kernel K2 on an (r, w) tile: column and value read; column, value
    and position written; the per-row counts."""
    return StageModel(
        "bin_sort_compress",
        bytes_moved=float(r * w * (3 * INDEX_BYTES + 2 * itemsize)
                          + r * INDEX_BYTES),
        flops=float(r * w), dtype="float64" if itemsize == 8 else "float32")


# ---- the port's methods ------------------------------------------------------------


def _bsr_counts(a, b, c, block_shape=(8, 128), bn: int = 128):
    """(pairs, nnzb_a, nnzb_b, nnzb_c) of ops/bsr.spgemm_bsr's blocking:
    A at (bm, bk), B at (bk, bn), C at (bm, bn); host scipy."""
    import numpy as np
    import scipy.sparse as sp

    bm, bk = block_shape
    a_b = sp.bsr_matrix(a.to_scipy(), blocksize=(bm, bk))
    b_b = sp.bsr_matrix(b.to_scipy(), blocksize=(bk, bn))
    c_b = sp.bsr_matrix(c.to_scipy(), blocksize=(bm, bn))
    pairs = int(np.diff(b_b.indptr)[a_b.indices].sum())
    return pairs, int(a_b.indptr[-1]), int(b_b.indptr[-1]), int(c_b.indptr[-1])


def spgemm_models(a, b, c, method: str, *, planes: bool = False,
                  plan=None):
    """(stage models, ``_bound``) of C = A @ B computed by ``method`` (a
    resolved method, not 'auto') from the port's own plans: the plan-aware
    model of tilepack, grouped and chunked (their host plans; a plan that
    does not fit falls to chunked, as ``api.spgemm`` does), dia, bsr and
    dense, as the reference bench chooses; the generic expand-sort-
    compress model for the methods with none. ``planes``: the timed
    window receives dia's operands as DIA planes, not CSR. ``plan``: the
    tilepack or grouped schedule or chunked plan that the timed run used
    (built here when None)."""
    from ..ops import symbolic
    from ..sparse.csr import host_view
    from ..sparse.dia import dia_offsets_of

    m, k, n = a.m, a.n, b.n
    itemsize = a.vals.element_size()
    nnz_a = int(host_view(a.rowptr)[-1])
    nnz_b = int(host_view(b.rowptr)[-1])
    nnz_c = int(host_view(c.rowptr)[-1])
    products = int(symbolic.total_products(a, b))
    bound = csr_product_bound(m, k, nnz_a, nnz_b, nnz_c, products, itemsize,
                              _dtype_name(a.vals.dtype))
    if method == "dia":
        import numpy as np

        offs_a = [int(d) for d in dia_offsets_of(a)]
        offs_b = offs_a if b is a else [int(d) for d in dia_offsets_of(b)]
        nd_c = len(np.unique(np.add.outer(offs_a, offs_b)))
        models = dia_stage_models(len(offs_a), nd_c, n, itemsize,
                                  nd_b=len(offs_b),
                                  flops=dia_flops(offs_a, offs_b, k, n),
                                  nnz_c=nnz_c)
        if planes:
            acc = _acc(itemsize)[0]
            bound = product_bound(len(offs_a) * k * acc,
                                  len(offs_b) * n * acc,
                                  csr_bytes(m, nnz_c, itemsize), products,
                                  bound.dtype)
        return models, bound
    if method == "bsr":
        return bsr_stage_models(*_bsr_counts(a, b, c), itemsize=itemsize), bound
    if method == "dense":
        holes = m * n - nnz_c
        mode = ("identity" if holes == 0 else
                "shift" if holes < (m * n) // 8 else "scan")
        return dense_stage_models(m, k, n, nnz_a, nnz_c, itemsize,
                                  extract_mode=mode), bound
    args = dict(nnz_a=nnz_a, nnz_b=nnz_b, m=m, nnz_c=nnz_c, itemsize=itemsize)
    if method == "tilepack":
        from ..ops.tilepack import make_tilepack_plan

        sched = plan if plan is not None else make_tilepack_plan(a, b)
        if sched is not None:
            return tilepack_stage_models(sched.plan, **args), bound
        method = "chunked"
    if method == "grouped":
        from ..ops.grouped import make_grouped_plan

        sched = plan if plan is not None else make_grouped_plan(a, b)
        if sched is not None:
            return grouped_stage_models(sched.plan, **args), bound
        method = "chunked"
    if method == "chunked":
        from ..ops.chunked import make_chunked_plan

        plan = plan if plan is not None else make_chunked_plan(a, b)
        return chunked_stage_models(plan, n=n, **args), bound
    return spgemm_stage_models(nnz_a, nnz_b, m, products, nnz_c,
                               itemsize), bound


# ---- the report ------------------------------------------------------------------


def _on_card(measured_on) -> bool:
    if measured_on is None:
        return False
    import torch

    return torch.device(measured_on).type == "cuda"


def _entry(sm: StageModel, chip: ChipSpec) -> dict:
    return {"bytes": sm.bytes_moved, "flops": sm.flops,
            "sol_time_s": sm.sol_time_s(chip), "bound_by": sm.bound_by(chip)}


def _share(sol: float, t: float | None, on_card: bool):
    return sol / t if on_card and t else None


def roofline_report(
    stage_models: dict[str, StageModel],
    stage_times_s: dict[str, float] | None = None,
    total_time_s: float | None = None,
    chip: ChipSpec | None = None,
    *,
    bound: StageModel | None = None,
    measured_on=None,
) -> dict:
    """Speed-of-light per stage, ``_total`` (their sum: the plan-aware
    bound) and, with ``bound``, ``_bound`` (``product_bound``: the
    method-independent one). Times are shares of a measured time only when
    ``measured_on`` is a CUDA device; otherwise ``sol_fraction`` is None.
    ``chip`` defaults to the card of ``measured_on`` (``chip_spec``)."""
    on_card = _on_card(measured_on)
    if chip is None:
        chip = chip_spec(measured_on if on_card else "cpu")
    report = {}
    sol_total = 0.0
    for name, sm in stage_models.items():
        entry = _entry(sm, chip)
        sol_total += entry["sol_time_s"]
        if stage_times_s and name in stage_times_s:
            t = stage_times_s[name]
            entry["time_s"] = t
            entry["sol_fraction"] = _share(entry["sol_time_s"], t, on_card)
        report[name] = entry
    report["_total"] = {"sol_time_s": sol_total, "chip": chip.name}
    if bound is not None:
        report["_bound"] = _entry(bound, chip)
    if total_time_s is not None:
        for key in ("_total", "_bound"):
            if key in report:
                report[key]["time_s"] = total_time_s
                report[key]["sol_fraction"] = _share(
                    report[key]["sol_time_s"], total_time_s, on_card)
    return report
