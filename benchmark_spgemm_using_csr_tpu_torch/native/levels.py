"""ctypes binding + lazy build for the native SpTRSV level scheduler
(levels.cpp), built into the package's ``_build/`` directory at first use.
Falls back to a numpy/Python loop when no C++ compiler is available; both
compute the same levels on the host.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from ..ops import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "levels.cpp")


@functools.cache
def _load():
    try:
        lib = _build.shared_library(_SRC, ["g++", "-O3", "-shared", "-fPIC"],
                                    timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.csr_levels.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.csr_levels.restype = ctypes.c_int
    return lib


def have_native() -> bool:
    """Whether the C++ scheduler builds and loads here (else the numpy
    fallback runs)."""
    return _load() is not None


def csr_levels(rowptr: np.ndarray, colidx: np.ndarray, m: int,
               upper: bool) -> np.ndarray:
    """Dependency level per row for the triangular-solve DAG (0-based)."""
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    levels = np.zeros(m, np.int32)
    lib = _load()
    if lib is not None:
        rc = lib.csr_levels(m, rowptr, colidx, int(upper), levels)
        if rc == 0:
            return levels
    return _levels_numpy(rowptr, colidx, m, upper)


def _levels_numpy(rowptr, colidx, m: int, upper: bool) -> np.ndarray:
    """The same sequential recurrence in Python."""
    levels = np.zeros(m, np.int32)
    order = range(m - 1, -1, -1) if upper else range(m)
    for i in order:
        seg = colidx[rowptr[i]:rowptr[i + 1]]
        deps = seg[seg > i] if upper else seg[seg < i]
        deps = deps[deps < m]
        if deps.size:
            levels[i] = int(levels[deps].max()) + 1
    return levels
