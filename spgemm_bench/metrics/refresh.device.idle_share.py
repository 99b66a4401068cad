"""refresh.device.idle_share: ``device.idle_share``
(``metrics/device.idle_share.py``) of the AMG refresh, where it moves
the refresh's own end-to-end metric, ``refresh_gflops``."""
from spgemm_bench.cells import reader

read = reader("device.idle_share")
