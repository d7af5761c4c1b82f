"""Fully-factorized learned entropy model (mmnc_tpu/entropy/entropy_bottleneck.py).

A learned univariate density per channel from a K-layer monotone MLP
chain (softplus(matrix) @ x + bias, then x + tanh(factor) * tanh(x)),
filters (3, 3, 3, 3), and learnable `quantiles` (left tail, median, right
tail). Parameter names and shapes follow the reference's state_dict:
`_matrix{k}` (C, f_out, f_in), `_bias{k}` (C, f_out, 1), `_factor{k}`
(C, f_out, 1), `quantiles` (C, 1, 3). Training quantizes with additive
noise; `aux_loss` trains the quantiles toward the tails and the median.
"""

import math

import torch
import torch.nn as nn

from ..ops.bound import abs_, lower_bound
from ..ops.quant import quantize_noise, quantize_round

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
INIT_SCALE = 10.0
FILTERS = (3, 3, 3, 3)


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus as written there: logaddexp(x, 0), with the
    gradient of jnp.logaddexp's custom JVP, exp(x - softplus(x)). Autograd
    through this forward would give 1 at x = 0 (clamp's gradient plus
    abs's 0) where JAX gives 1/2."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


_softplus = _Softplus.apply


def _sign_sigmoid_likelihood(lower, upper):
    """|sigmoid(s*upper) - sigmoid(s*lower)| with s = -sign(lower+upper)."""
    sign = -torch.sign(lower + upper).detach()
    return abs_(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))


class EntropyBottleneck(nn.Module):
    """Factorized prior over the channels of an NCHW tensor."""

    def __init__(self, channels):
        super().__init__()
        self.channels = channels
        filters = (1,) + FILTERS + (1,)
        for k in range(len(FILTERS) + 1):
            f_in, f_out = filters[k], filters[k + 1]
            self.register_parameter(
                f"_matrix{k}", nn.Parameter(torch.empty(channels, f_out, f_in)))
            self.register_parameter(
                f"_bias{k}", nn.Parameter(torch.empty(channels, f_out, 1)))
            if k < len(FILTERS):
                self.register_parameter(
                    f"_factor{k}",
                    nn.Parameter(torch.empty(channels, f_out, 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))

    @torch.no_grad()
    def init_parameters(self, generator):
        """entropy_bottleneck.py:74-100: constant matrices, U(-1/2, 1/2)
        biases, zero factors, quantiles (-10, 0, 10)."""
        scale = INIT_SCALE ** (1.0 / (len(FILTERS) + 1))
        for k in range(len(FILTERS) + 1):
            matrix = getattr(self, f"_matrix{k}")
            matrix.fill_(math.log(math.expm1(1.0 / scale / matrix.shape[1])))
            bias = getattr(self, f"_bias{k}")
            draw = torch.empty(bias.shape).uniform_(-0.5, 0.5,
                                                    generator=generator)
            bias.copy_(draw)
            if k < len(FILTERS):
                getattr(self, f"_factor{k}").zero_()
        q = torch.tensor([-INIT_SCALE, 0.0, INIT_SCALE])
        self.quantiles.copy_(q.expand(self.channels, 1, 3))

    def medians(self):
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, x, stop_density_grad: bool):
        """Logits of the cumulative at x: (C, 1, N) -> (C, 1, N)."""
        logits = x
        k_max = len(FILTERS) + 1
        for k in range(k_max):
            m = getattr(self, f"_matrix{k}")
            b = getattr(self, f"_bias{k}")
            if stop_density_grad:
                m, b = m.detach(), b.detach()
            logits = torch.matmul(_softplus(m), logits) + b
            if k < k_max - 1:
                f = getattr(self, f"_factor{k}")
                if stop_density_grad:
                    f = f.detach()
                logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    def likelihood(self, x_hat):
        """Likelihood of quantized NCHW values, same shape."""
        b, c, h, w = x_hat.shape
        v = x_hat.float().permute(1, 0, 2, 3).reshape(c, 1, -1)
        lower = self._logits_cumulative(v - 0.5, stop_density_grad=False)
        upper = self._logits_cumulative(v + 0.5, stop_density_grad=False)
        lik = lower_bound(_sign_sigmoid_likelihood(lower, upper),
                          LIKELIHOOD_BOUND)
        return lik.reshape(c, b, h, w).permute(1, 0, 2, 3)

    def forward(self, x, training: bool = False, noise=None):
        """NCHW x -> (x_hat, likelihoods). Training adds `noise` (U(-1/2,
        1/2), x's shape); eval rounds around the medians."""
        if training:
            x_hat = quantize_noise(x, noise)
        else:
            x_hat = quantize_round(x, self.medians().view(1, -1, 1, 1))
        return x_hat, self.likelihood(x_hat)

    def aux_loss(self):
        """sum |logits(quantiles) - (-t, 0, t)|, t = log(2 / TAIL_MASS - 1):
        trains the quantiles only (the density parameters are detached)."""
        logits = self._logits_cumulative(self.quantiles, stop_density_grad=True)
        target = math.log(2.0 / TAIL_MASS - 1.0)
        # (-1, 0, 1) made on the device: a host tensor would be copied over
        # and wait for the stream
        signs = torch.arange(-1.0, 2.0, device=logits.device)
        return torch.sum(abs_(logits - target * signs))


def eb_pmf(eb: EntropyBottleneck, quantiles, max_length: int, minima):
    """Sample the per-channel pmf over the quantile-spanned integer range.

    quantiles (C, 1, 3) float32, minima (C,) int64; samples for channel c
    start at median_c - minima_c. Returns (pmf (C, max_length),
    tail_mass (C,)) as float32 tensors on the module's device.
    """
    medians = quantiles[:, 0, 1]
    pmf_start = medians - minima.to(torch.float32)
    samples = (torch.arange(max_length, dtype=torch.float32,
                            device=quantiles.device)[None, None, :]
               + pmf_start[:, None, None])
    lower = eb._logits_cumulative(samples - 0.5, stop_density_grad=True)
    upper = eb._logits_cumulative(samples + 0.5, stop_density_grad=True)
    pmf = _sign_sigmoid_likelihood(lower, upper)[:, 0, :]
    tail_mass = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
    return pmf, tail_mass
