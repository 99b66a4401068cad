"""The benchmark of ``benchmark_spgemm_using_csr_tpu_torch``, the PyTorch
and CUDA SpGEMM library, on one NVIDIA card: ``python3 -m spgemm_bench
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (``harness``).

It imports neither JAX nor the JAX package ``benchmark_spgemm_using_csr_tpu``;
its plain reference (``reference/``) imports nothing of the program.
"""
import time

# the process's start, as near as the package can read it: set-up time
# runs from here to the measured window
START = time.time()
