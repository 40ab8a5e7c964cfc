"""Time-step kernels: the plain torch step twin and the CUDA scanres engine."""
