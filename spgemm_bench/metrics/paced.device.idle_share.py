"""paced.device.idle_share: ``device.idle_share``
(``metrics/device.idle_share.py``) of the cell whose calls the host
paces, where it moves its own end-to-end metric, ``paced_gflops``, in
place of the device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("device.idle_share")
