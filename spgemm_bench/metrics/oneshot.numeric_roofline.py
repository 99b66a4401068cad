"""oneshot.numeric_roofline: ``numeric_roofline``
(``metrics/numeric_roofline.py``) of the one-shot cell, where it moves
that cell's own end-to-end metric in place of the steady cells'."""
from spgemm_bench.cells import reader

read = reader("numeric_roofline")
