"""Config system: the facade's knobs as a frozen dataclass, so they are
runtime-configurable and testable. The reference package's other fields
(dtypes, capacity floor) belong to methods not ported yet and come with
them."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SpGemmConfig:
    """Tuning knobs for the SpGEMM pipeline."""

    # binned method: rows with nnzCt <= width go to the sort kernel of that
    # width; rows beyond the last width take the global ESC path
    bin_widths: Tuple[int, ...] = (8, 32, 128, 512)
    # numeric method: auto|esc|chunked|grouped|tilepack|dia|tiled|binned
    method: str = "auto"
    # trim outputs to pad_bucket(nnzC) after compute
    trim: bool = True


DEFAULT = SpGemmConfig()
