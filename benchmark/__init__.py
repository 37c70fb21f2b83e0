"""The benchmark of the PyTorch/CUDA port (``odwscl_tpu_torch``); see
``run.py`` and ``BENCHMARK.json``."""
