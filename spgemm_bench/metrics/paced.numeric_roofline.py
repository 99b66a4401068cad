"""paced.numeric_roofline: ``numeric_roofline``
(``metrics/numeric_roofline.py``) of the cell whose calls the host
paces, where it moves its own end-to-end metric, ``paced_gflops``, in
place of the device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("numeric_roofline")
