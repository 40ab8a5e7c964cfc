"""Throughput harnesses on the card (counterpart of ``tpufwi/bench/``):
``bench_3d``, the 3D step at SEG/EAGE Overthrust scale."""
