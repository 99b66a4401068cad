"""The benchmark's inputs, made from a configuration's file and ``--seed``.

- The matrix's structure and base values come from the configuration's
  generator (``generators/<name>.py``), with the configuration's own
  parameters: the same for every seed, so every seed does the same work.
- The values of each call are made on the device from the seed, in one
  call for all of a run's value sets: every base value scaled by
  1 + spread·u, u uniform in [-1, 1). The scale keeps each value's sign,
  so a sum whose terms share a sign never cancels to 0.
- A one-shot call's operand is P·A·Pᵀ for a permutation P drawn from the
  seed and the call's index, applied on the device.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

# independent streams drawn from one seed
VALUES, PERMUTATION, SAMPLE = 1, 2, 3


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed of its own for (seed, stream, index); any whole seed."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream,
                                 int(index) + (1 << 32)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device, index: int = 0
              ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, index))
    return g


def matrix(config: dict):
    """(rowptr, colidx, vals, shape): host arrays of the configuration's
    matrix in canonical CSR order."""
    gen = importlib.import_module(
        f"spgemm_bench.generators.{config['generator']}")
    return gen.generate(**config["params"])


def value_sets(base: torch.Tensor, count: int, spread: float, seed: int
               ) -> torch.Tensor:
    """(count, nnz) values on base's device: base·(1 + spread·u)."""
    g = generator(seed, VALUES, base.device)
    u = torch.rand((count, base.shape[0]), generator=g, device=base.device,
                   dtype=torch.float32)
    return base[None, :] * (1.0 + spread * (2.0 * u - 1.0))


def permute(rowptr: torch.Tensor, colidx: torch.Tensor, vals: torch.Tensor,
            n: int, seed: int, index: int):
    """(rowptr, colidx, vals) of P·A·Pᵀ, in canonical order, for the
    permutation P of (seed, index); int64 structure on A's device."""
    dev = rowptr.device
    g = generator(seed, PERMUTATION, dev, index)
    perm = torch.randperm(n, generator=g, device=dev)
    nnz = colidx.shape[0]
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  rowptr[1:] - rowptr[:-1], output_size=nnz)
    new_row = perm[row]
    key = new_row * n + perm[colidx.long()]
    key, order = torch.sort(key)
    counts = torch.bincount(new_row, minlength=n)
    out_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return out_ptr, key - torch.div(key, n, rounding_mode="floor") * n, \
        vals[order]
