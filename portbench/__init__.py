"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``README.md`` says how
cells, configurations, traffic mixes and per-layer metrics are found.
"""
