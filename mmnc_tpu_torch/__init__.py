"""PyTorch/CUDA port of mmnc_tpu, the multi-modal multi-task neural codec.

The JAX package `mmnc_tpu` is the reference; this package runs the same
codec on an NVIDIA H100 with PyTorch and two hand-written CUDA kernels
(`ops/gdn.py`, `ops/deconv_igdn.py`). Entry points run on CUDA unless the
caller passes `device="cpu"`; with no card and no device they raise.

Public surface: `build_model` (models 1-4: the single-task, mixed,
disjoint and shared codecs) with eval `forward`,
`update_bottleneck_values`, `compress`, `decompress`, partial coding
(`compress_partial`, `decompress_tasks`) and the training side;
`bitstream` (the container); `data` (synthetic scenes, the CLEVR
contract, prerender, `BatchLoader` with `prefetch_to_device`, the
device-resident dataset); `train` (the train and eval steps, and
`train.fit`: the epoch loop with validation, checkpoints and resume);
`utils` (checkpoints, the metric sink, profiling); the CLIs `python -m
mmnc_tpu_torch.cli.train` and `python -m mmnc_tpu_torch.cli.compress`;
`weights.state_dict_from_jax` to carry JAX params over.
"""

from .models.codecs import (MultiTaskDisjointLatentCompressor,
                            MultiTaskMixedLatentCompressor,
                            MultiTaskSharedLatentCompressor,
                            SingleTaskCompressor, build_model)

__all__ = ["MultiTaskDisjointLatentCompressor",
           "MultiTaskMixedLatentCompressor",
           "MultiTaskSharedLatentCompressor", "SingleTaskCompressor",
           "build_model"]
