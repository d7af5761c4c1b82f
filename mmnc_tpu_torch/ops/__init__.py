"""Layers and the two hand-written CUDA kernels of the port."""
