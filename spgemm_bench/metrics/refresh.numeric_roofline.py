"""refresh.numeric_roofline: ``numeric_roofline``
(``metrics/numeric_roofline.py``) of the AMG refresh, where it moves
the refresh's own end-to-end metric, ``refresh_gflops``."""
from spgemm_bench.cells import reader

read = reader("numeric_roofline")
