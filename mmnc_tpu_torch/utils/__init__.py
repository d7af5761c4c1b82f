"""Checkpoints, the metric sink and image grids, profiling
(mmnc_tpu/utils)."""
