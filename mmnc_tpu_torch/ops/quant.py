"""Quantization for entropy-model training and eval (mmnc_tpu/ops/quant.py).

Train-time: additive U(-1/2, 1/2) noise, a differentiable surrogate. The
noise is a tensor the caller gives (`quantize_noise`), drawn by
`uniform_noise` from an explicit `torch.Generator`, so one step can be
replayed with the same noise (and a checkpointed region recomputed with
it). Eval: hard round, optionally around per-channel medians; `quantize_ste`
rounds with a straight-through gradient. `torch.round` rounds half to even,
as `jnp.round` does.
"""

import torch


def uniform_noise(shape, generator: torch.Generator, device=None,
                  dtype=torch.float32):
    """U(-1/2, 1/2) noise of `shape` and `dtype` (the activations', as
    mmnc_tpu/ops/quant.py:14 draws it) from `generator` on `device` (the
    generator's own device unless given)."""
    device = generator.device if device is None else device
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-0.5, 0.5, generator=generator)


def quantize_noise(x, noise):
    """x + noise, the noise U(-1/2, 1/2) of x's shape (`uniform_noise`),
    in x's type: JAX draws it in x's dtype, so a bf16 x stays bf16 (torch
    would promote bf16 + float32 to float32)."""
    return x + noise.to(x.dtype)


def quantize_round(x, medians=None):
    """Hard round, optionally around per-channel medians broadcast onto x."""
    if medians is None:
        return torch.round(x)
    return torch.round(x - medians) + medians


class _STERound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_ste(x, medians=None):
    """Straight-through round: forward rounds, backward is the identity."""
    if medians is None:
        return _STERound.apply(x)
    return _STERound.apply(x - medians) + medians
