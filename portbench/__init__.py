"""The benchmark of the PyTorch/CUDA port (``sgc_tpu_torch``), driven by
``BENCHMARK.json`` at the repository root. See README.md."""
