"""The benchmark of the PyTorch and CUDA port (`lumenrenderer_tpu_torch`):
cells found by name from `BENCHMARK.json`, run by `perfbench/run.py`."""
