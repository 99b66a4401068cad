"""paced.numeric.device_ms: ``numeric.device_ms``
(``metrics/numeric.device_ms.py``) of the cell whose calls the host
paces, where it moves its own end-to-end metric, ``paced_gflops``, in
place of the device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("numeric.device_ms")
