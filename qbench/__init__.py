"""The benchmark of the PyTorch and CUDA port ``quiver_tpu_torch``.

``python3 -m qbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. See ``qbench/README.md``.
"""
