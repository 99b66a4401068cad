"""paced_gflops: ``gflops`` (``metrics/gflops.py``) of the cells whose
calls the host paces: a host sync inside each call (dia's
``DIA.to_csr``) or host launch gaps between a call's graph replays (the
AMG refresh). Their runs spread with the host's speed, far wider than a
device-bound cell's, so it carries a bound of its own."""
from spgemm_bench.cells import reader

read = reader("gflops")
