"""PyTorch/CUDA port of mmnc_tpu, the multi-modal multi-task neural codec.

The JAX package `mmnc_tpu` is the reference; this package runs the same
codec on an NVIDIA H100 with PyTorch and two hand-written CUDA kernels
(`ops/gdn.py`, `ops/deconv_igdn.py`). Entry points run on CUDA unless the
caller passes `device="cpu"`; with no card and no device they raise.

Public surface (this slice): `build_model` / `SingleTaskCompressor` with
eval `forward`, `update_bottleneck_values`, `compress` and `decompress`,
and `weights.state_dict_from_jax` to carry JAX params over.
"""

from .models.codecs import SingleTaskCompressor, build_model

__all__ = ["SingleTaskCompressor", "build_model"]
