"""Bound ops with pass-through-inward gradients (mmnc_tpu/ops/bound.py).

The gradient passes where the value is inside the bound OR where the
upstream gradient pushes it back toward the feasible set. `abs_` is |x|
with JAX's gradient at 0.
"""

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x, bound: float):
    return _LowerBound.apply(x, bound)


def upper_bound(x, bound: float):
    return _UpperBound.apply(x, bound)


def abs_(x):
    """|x| with the gradient jnp.abs has: +g at x = 0, where torch.abs's
    gradient is 0 (JAX's rule is select(x >= 0, g, -g))."""
    return torch.where(x >= 0, x, -x)
