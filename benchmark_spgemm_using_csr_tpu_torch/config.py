"""Config system: the facade's knobs as a frozen dataclass, so they are
runtime-configurable and testable. The reference package's other fields
(value and index dtypes, capacity floor) are read by none of its paths and
are not carried."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SpGemmConfig:
    """Tuning knobs for the SpGEMM pipeline."""

    # binned and fused methods: rows with nnzCt <= width go to the sort
    # kernel of that width; rows beyond the last width take the global ESC
    # path
    bin_widths: Tuple[int, ...] = (8, 32, 128, 512)
    # numeric method: auto or one of api.spgemm's methods
    method: str = "auto"
    # trim outputs to pad_bucket(nnzC) after compute
    trim: bool = True


DEFAULT = SpGemmConfig()
