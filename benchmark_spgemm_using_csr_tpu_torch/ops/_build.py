"""Build the package's native sources into ``_build/`` and load them.

Sources live in the checkout (``csrc/*.cu``, ``native/*.cpp``); outputs go
to ``benchmark_spgemm_using_csr_tpu_torch/_build/``, which git ignores. A
library is rebuilt when it is missing or older than its source, so a fresh
checkout builds at first use. Builds write to a private temporary name and
rename into place, so concurrent processes never load a half-written file.

CUDA sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``: this builds
in seconds, where an extension that includes PyTorch's headers takes
minutes. Each library has its own lock, so ``build_cuda`` compiles every
kernel at once, one nvcc process per source.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
# the hand-written kernels, csrc/<name>.cu
CUDA_KERNELS = ("tile_sort_merge", "bin_sort_compress", "dia_spgemm_fused",
                "dia_to_csr", "symbolic_count", "rowlocal_esc", "pair_stats")

_lock = threading.Lock()  # guards _out_locks
_out_locks: dict = {}
_loaded: dict = {}


def _up_to_date(out: str, deps) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(d) for d in deps)


def shared_library(src: str, command: list, timeout: int = 600,
                   deps=()) -> ctypes.CDLL:
    """Compile ``src`` with ``command + ["-o", <out>, src]`` into
    ``_build/lib<stem>.so`` unless a build newer than ``src`` and ``deps``
    exists, and load it.

    Raises ``subprocess.CalledProcessError`` (with the compiler's output)
    when the build fails."""
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}.so")
    with _lock:
        out_lock = _out_locks.setdefault(out, threading.Lock())
    with out_lock:
        lib = _loaded.get(out)
        if lib is not None:
            return lib
        if not _up_to_date(out, [src, *deps]):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    command + ["-o", tmp, src],
                    check=True, capture_output=True, text=True,
                    timeout=timeout,
                )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(out)
        _loaded[out] = lib
        return lib


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def cuda_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` for sm_90a (rebuilt when it or any
    ``csrc/*.cuh`` changed) and load it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    cmd = [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    ]
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return shared_library(src, cmd, deps=headers)


@functools.cache
def _entry_point(name: str, argtypes: tuple):
    """``<name>_launch`` of ``csrc/<name>.cu`` with its signature (built
    and loaded at first use); it returns a CUDA error code."""
    fn = getattr(cuda_library(name), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, device, *args) -> None:
    """Call the C entry point ``<name>_launch`` of ``csrc/<name>.cu``
    (``argtypes`` without the trailing stream) with ``args`` and PyTorch's
    current stream on ``device``; raise if the launch was refused."""
    import torch

    fn = _entry_point(name, (*argtypes, ctypes.c_void_p))
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def build_cuda() -> dict:
    """Build and load every kernel now, all at once (one nvcc each).
    Returns {name: seconds its build and load took}."""
    def timed(name):
        t0 = time.perf_counter()
        cuda_library(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(CUDA_KERNELS)) as pool:
        futures = {name: pool.submit(timed, name) for name in CUDA_KERNELS}
        return {name: f.result() for name, f in futures.items()}
