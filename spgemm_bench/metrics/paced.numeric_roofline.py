"""paced.numeric_roofline: ``numeric_roofline``
(``metrics/numeric_roofline.py``) of the cells whose calls the host
paces, where it moves their own end-to-end metric in place of the
device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("numeric_roofline")
