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
`utils` (checkpoints, the metric sink, profiling); `analysis` (RD
points, check_bpp, per-channel bpp, latent probing, learned and classical
baselines); `parallel` (data parallelism, one process per device:
`launch`, `make_mesh`); the CLIs `python -m mmnc_tpu_torch.cli.train`
(`-g N` on N devices), `python -m mmnc_tpu_torch.cli.compress` and
`python -m mmnc_tpu_torch.cli.rd_sweep`; `weights.state_dict_from_jax`
to carry JAX params over.
"""

from .models.codecs import (MultiTaskDisjointLatentCompressor,
                            MultiTaskMixedLatentCompressor,
                            MultiTaskSharedLatentCompressor,
                            SingleTaskCompressor, build_model)

__all__ = ["MultiTaskDisjointLatentCompressor",
           "MultiTaskMixedLatentCompressor",
           "MultiTaskSharedLatentCompressor", "SingleTaskCompressor",
           "build_model"]
