"""Failure detection / retry-from-last-phase, as in the reference package's
``utils/retry.py``.

``retry`` re-runs a phase callable with exponential backoff, and
``Checkpointer`` pairs it with the CSR save/load so a multi-phase pipeline
(an AMG hierarchy build: one SpGEMM chain per level) resumes from the last
completed phase. A checkpoint loads onto the device the caller names.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, TypeVar

T = TypeVar("T")
log = logging.getLogger(__name__)


def retry(
    fn: Callable[[], T],
    attempts: int = 3,
    backoff_s: float = 1.0,
    retry_on: tuple = (RuntimeError,),
) -> T:
    """Run ``fn`` with up to ``attempts`` tries and exponential backoff."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            last = e
            log.warning("attempt %d/%d failed: %s", i + 1, attempts, e)
            if i + 1 < attempts:
                time.sleep(backoff_s * (2**i))
    raise last


class Checkpointer:
    """Phase-level checkpoint/resume for CSR-producing pipelines.

    >>> ck = Checkpointer("run1")
    >>> c = ck.phase("level0", lambda: spgemm(a, a), device="cuda")  # computes + saves
    >>> c = ck.phase("level0", lambda: spgemm(a, a), device="cuda")  # loads, skips compute
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.npz")

    def done(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def phase(self, name: str, fn: Callable[[], "CSR"], attempts: int = 3, *,
              device):
        from ..sparse.csr import CSR

        p = self._path(name)
        if os.path.exists(p):
            log.info("phase %s: resuming from checkpoint", name)
            return CSR.load(p, device=device)
        result = retry(fn, attempts=attempts)
        result.save(p)
        return result
