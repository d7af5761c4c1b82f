"""Eval-time quantization (mmnc_tpu/ops/quant.py:quantize_round).

`torch.round` rounds half to even, as `jnp.round` does.
"""

import torch


def quantize_round(x, medians=None):
    """Hard round, optionally around per-channel medians broadcast onto x."""
    if medians is None:
        return torch.round(x)
    return torch.round(x - medians) + medians
