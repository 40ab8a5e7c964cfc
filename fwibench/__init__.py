"""The benchmark of the PyTorch and CUDA port (``tpufwi_torch``): see
``run.py`` for the command and ``BENCHMARK.json`` at the checkout's root
for its cells and metrics."""
