"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 hyca_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``hyca_bench/README.md``.
"""
