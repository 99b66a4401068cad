"""oneshot.graphs.captures: ``graphs.captures``
(``metrics/graphs.captures.py``) of the one-shot cell, where it moves
that cell's own end-to-end metric in place of the steady cells'."""
from spgemm_bench.cells import reader

read = reader("graphs.captures")
