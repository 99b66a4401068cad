"""``python3 -m spgemm_bench``: see ``harness``."""
import os
import sys

# caches of compilers the program may call stay at fixed paths inside the
# checkout (its own kernels build into its ``_build/``)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(_var, os.path.join(_ROOT, "_bench_cache", _sub))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from spgemm_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
