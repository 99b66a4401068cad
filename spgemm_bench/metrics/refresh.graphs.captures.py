"""refresh.graphs.captures: ``graphs.captures``
(``metrics/graphs.captures.py``) of the AMG refresh, where it moves
the refresh's own end-to-end metric, ``refresh_gflops``."""
from spgemm_bench.cells import reader

read = reader("graphs.captures")
