"""paced.numeric.device_ms: ``numeric.device_ms``
(``metrics/numeric.device_ms.py``) of the cells whose calls the host
paces, where it moves their own end-to-end metric in place of the
device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("numeric.device_ms")
