"""Bound ops with pass-through-inward gradients (mmnc_tpu/ops/bound.py).

The gradient passes where the value is inside the bound OR where the
upstream gradient pushes it back toward the feasible set. `abs_` is |x|
with JAX's gradient at 0.

That gate is not linear in the gradient, so a data-parallel step must
gate a parameter's gradient after summing it over the ranks, as the
single-process step (and XLA's sharded one) gates the global batch's:
gating each rank's share first would let a gradient through where the
shares disagree in sign and their sum is held. `gates_after_reduce`
defers the gate of `lower_bound` taken directly on a parameter, and
applies it to the reduced gradient.
"""

import contextlib

import torch

# id(parameter) -> [parameter, its bound or None]: the parameters whose
# lower_bound gate an open `gates_after_reduce` defers
_deferred = {}


def _gate(x, g, bound):
    return torch.where((x >= bound) | (g < 0), g, torch.zeros_like(g))


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        entry = _deferred.get(id(x))
        ctx.deferred = entry is not None and entry[0] is x
        if ctx.deferred:
            entry[1] = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        if ctx.deferred:
            return g, None
        (x,) = ctx.saved_tensors
        return _gate(x, g, ctx.bound), None


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


@contextlib.contextmanager
def gates_after_reduce(params):
    """While open, `lower_bound` taken directly on one of `params` passes
    its gradient through ungated and records its bound. Yields apply(),
    which gates those parameters' gradients in place, as the backward
    would have: call it after reducing them (it works once this is
    closed too). Each such parameter must reach the loss through its one
    bound alone (the GDN reparameterisations,
    `ops/layers.py:nonneg_forward`)."""
    entries = {id(p): [p, None] for p in params}
    _deferred.update(entries)

    def apply():
        for p, bound in entries.values():
            if bound is not None and p.grad is not None:
                p.grad.copy_(_gate(p, p.grad, bound))

    try:
        yield apply
    finally:
        for key in entries:
            _deferred.pop(key, None)


def upper_bound(x, bound: float):
    return _UpperBound.apply(x, bound)


def abs_(x):
    """|x| with the gradient jnp.abs has: +g at x = 0, where torch.abs's
    gradient is 0 (JAX's rule is select(x >= 0, g, -g))."""
    return torch.where(x >= 0, x, -x)
