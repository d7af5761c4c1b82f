"""Checkpoints, the metric sink and image grids, profiling, and the
import of reference (CompressAI / Lightning) checkpoints (mmnc_tpu/utils)."""
