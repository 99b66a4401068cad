"""refresh_gflops: ``gflops`` (``metrics/gflops.py``) of the AMG
refresh, whose call is the triple product's graph replays with the host's
launches and copy-in between them: its runs spread wider than a single
replay's, and far narrower than the host-paced dia call's
(``paced_gflops``), so it carries a bound of its own."""
from spgemm_bench.cells import reader

read = reader("gflops")
