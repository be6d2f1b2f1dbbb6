"""The benchmark of ``tpu_operator_torch``: the validator's card path, cell by cell.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one CUDA card (see ``README.md``).
"""
