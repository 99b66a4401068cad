"""paced.device.idle_share: ``device.idle_share``
(``metrics/device.idle_share.py``) of the cells whose calls the host
paces, where it moves their own end-to-end metric in place of the
device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("device.idle_share")
