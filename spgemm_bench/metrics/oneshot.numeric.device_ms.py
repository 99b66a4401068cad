"""oneshot.numeric.device_ms: ``numeric.device_ms``
(``metrics/numeric.device_ms.py``) of the one-shot cell, where it moves
that cell's own end-to-end metric in place of the steady cells'."""
from spgemm_bench.cells import reader

read = reader("numeric.device_ms")
