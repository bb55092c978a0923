"""leafbench: the benchmark of ``leaf_tpu_torch`` on one NVIDIA H100.

``python -m leafbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. See ``leafbench/README.md``.
"""
