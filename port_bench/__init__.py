"""Benchmark harness of the PyTorch/CUDA port (`unicore_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; `README.md` says how a
configuration, a traffic mix, a per-layer metric or a driver is added as
new files.
"""
