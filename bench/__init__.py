"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one
command runs one cell once (``bench/run.py``); everything a cell needs is
found by name from ``BENCHMARK.json``."""
