"""paced_gflops: ``gflops`` (``metrics/gflops.py``) of the cell whose
calls the host paces: dia's reuse call, K3 then K4, whose host wrappers
take longer than their kernels, so the device idles about three quarters
of the window. Its runs spread with the host's speed, far wider than a
device-bound cell's, so it carries a bound of its own."""
from spgemm_bench.cells import reader

read = reader("gflops")
