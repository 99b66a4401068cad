"""The reference repository's scripts that drive the library end to end,
ported: ``demo_large`` (C = A @ A out of core at BASELINE config #5's
problem size) and ``acceptance`` (the five BASELINE acceptance configs).
Each runs as ``python -m benchmark_spgemm_using_csr_tpu_torch.scripts.<name>``.
"""
