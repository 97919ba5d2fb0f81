"""The benchmark of the PyTorch/CUDA port (`balance_robot_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json`; see `PERF.md` for the cells,
their metrics and how `correct` is decided.
"""
