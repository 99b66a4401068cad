"""refresh.graphs.copy_mb: ``graphs.copy_mb``
(``metrics/graphs.copy_mb.py``) of the AMG refresh, where it moves
the refresh's own end-to-end metric, ``refresh_gflops``."""
from spgemm_bench.cells import reader

read = reader("graphs.copy_mb")
