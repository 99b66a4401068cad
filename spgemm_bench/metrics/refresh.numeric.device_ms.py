"""refresh.numeric.device_ms: ``numeric.device_ms``
(``metrics/numeric.device_ms.py``) of the AMG refresh, where it moves
the refresh's own end-to-end metric, ``refresh_gflops``."""
from spgemm_bench.cells import reader

read = reader("numeric.device_ms")
