"""Throughput harnesses on the card (counterpart of ``tpufwi/bench/`` and of
the machine-model probe scripts under ``scripts/``): ``bench_3d``, the 3D
step at SEG/EAGE Overthrust scale; ``exp_2d_scanres`` and ``exp_3d_lap``,
the probes."""
