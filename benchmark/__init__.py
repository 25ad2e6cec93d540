"""The benchmark of the PyTorch and CUDA port (``diral_tpu_torch``): see
README.md and ``BENCHMARK.json`` at the checkout's root."""
