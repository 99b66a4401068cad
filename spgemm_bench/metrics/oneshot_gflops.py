"""oneshot_gflops: ``gflops`` (``metrics/gflops.py``) of the one-shot cell.
Its calls take the host planner's time and its runs spread far wider
than the steady cells', so its end-to-end metrics carry bounds of their
own."""
from spgemm_bench.cells import reader

read = reader("gflops")
