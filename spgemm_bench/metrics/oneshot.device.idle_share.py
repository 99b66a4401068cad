"""oneshot.device.idle_share: ``device.idle_share``
(``metrics/device.idle_share.py``) of the one-shot cell, where it moves
that cell's own end-to-end metric in place of the steady cells'."""
from spgemm_bench.cells import reader

read = reader("device.idle_share")
