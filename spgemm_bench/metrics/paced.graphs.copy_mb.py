"""paced.graphs.copy_mb: ``graphs.copy_mb`` (``metrics/graphs.copy_mb.py``)
of the cells whose calls the host paces, where it moves their own
end-to-end metric in place of the device-bound cells'."""
from spgemm_bench.cells import reader

read = reader("graphs.copy_mb")
