"""Codec layers: strided conv, transposed conv and (I)GDN
(mmnc_tpu/ops/layers.py).

Activations are NCHW tensors in `channels_last` memory format, so the
NHWC view `x.permute(0, 2, 3, 1)` of every activation is contiguous and a
GDN is a pass over (B*H*W, C) rows. Geometry follows torch / CompressAI:
conv = Conv2d(k, s, padding k//2); deconv = ConvTranspose2d(k, s,
padding k//2, output_padding s-1), so k5/s2 halves and doubles even sizes.
Only the plain conv / transposed conv of the JAX package are ported; its
s2d, phase and packed lowerings (layers.py:51-185) are XLA tuning.

Init mirrors variance_scaling(1/3, fan_in, uniform) with fan_in =
k*k*Cin for conv AND deconv, zero biases (torch's own ConvTranspose2d
init takes fan_in from Cout and draws biases), GDN beta = 1 and
gamma = 0.1*I in the non-negative reparametrisation. Every draw comes from
a CPU `torch.Generator`, so a seed gives the same weights on any device.

`dtype` (float32 or bfloat16) is the activations' type, as the JAX
layers' (layers.py:232-233, 250-251, 300-314): parameters stay float32
(master weights) and each layer casts its input, weight, bias and gamma
to `dtype`. In bf16 a conv adds its bias after the conv, so its output is
rounded twice as JAX's is (F.conv2d with the bias would round once). The
two kernels take float32 parameters: the layers hand them the values
rounded to bf16. Under no-grad (decode, eval) a layer keeps what it
derives from its parameters (the bf16 copies, the deconv taps and GDN's
effective gamma and beta) until a parameter changes (`_derived`); with
grad enabled it derives them anew at each call, so that gradients reach
the float32 parameters, and a CUDA graph derives them at each replay.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import graphs
from .bound import lower_bound
from .deconv_igdn import deconv_igdn, deconv_weight_taps, bf16_conv
from .gdn import gdn

# NonNegativeParametrizer constants (mmnc_tpu/ops/layers.py:259-271)
_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_MIN = 1e-6


def nonneg_init(value):
    return torch.sqrt(torch.clamp_min(value + _PEDESTAL, _PEDESTAL))


def nonneg_forward(reparam, minimum: float = 0.0):
    bound = float((minimum + _REPARAM_OFFSET ** 2) ** 0.5)
    out = lower_bound(reparam, bound)
    return out * out - _PEDESTAL


def _derived(module, key, make, *params):
    """`make()`, which derives tensors from `params`. Under no-grad the
    result is kept on the module and reused while each parameter is the
    same tensor at the same version (an in-place update, an optimizer step
    or a load_state_dict bumps the version); with grad enabled it is made
    anew, and so it is while a stream captures a CUDA graph
    (`graphs.py`): the graph then derives it at every replay from the
    parameters as they are, as a jitted program does, and stays valid
    through in-place updates."""
    if torch.is_grad_enabled() or graphs.capturing(params[0].device):
        return make()
    stamp = tuple((p.data_ptr(), p._version, p.device) for p in params)
    cache = module.__dict__.setdefault("_derived_cache", {})
    kept = cache.get(key)
    if kept is None or kept[0] != stamp:
        kept = cache[key] = (stamp, make())
    return kept[1]


def _cast_parameters(layer):
    """A conv layer's weight and bias in its dtype."""
    return _derived(layer, "cast", lambda: (layer.weight.to(layer.dtype),
                                            layer.bias.to(layer.dtype)),
                    layer.weight, layer.bias)


def _rounded(t, dtype):
    """t's values rounded to `dtype`, kept in t's float32 (for the kernels,
    which take float32 parameters)."""
    return t if dtype == t.dtype else t.to(dtype).to(t.dtype)


def _uniform_(param, limit, generator):
    draw = torch.empty(param.shape, dtype=torch.float32)
    draw.uniform_(-limit, limit, generator=generator)
    param.copy_(draw)


class Conv(nn.Module):
    """conv(k, s): cross-correlation with padding k//2, weight (O, I, k, k)."""

    def __init__(self, in_channels, out_channels, kernel_size=5, stride=2,
                 dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def init_parameters(self, generator):
        _, cin, k, _ = self.weight.shape
        _uniform_(self.weight, math.sqrt(1.0 / (k * k * cin)), generator)
        self.bias.zero_()

    def forward(self, x):
        pad = self.weight.shape[-1] // 2
        if self.dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, pad)
        w, b = _cast_parameters(self)
        return bf16_conv(F.conv2d, x.to(self.dtype), w, stride=self.stride,
                         padding=pad) + b.view(-1, 1, 1)


class Deconv(nn.Module):
    """deconv(k, s): ConvTranspose2d geometry, weight (I, O, k, k)."""

    def __init__(self, in_channels, out_channels, kernel_size=5, stride=2,
                 dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def init_parameters(self, generator):
        cin, _, k, _ = self.weight.shape
        _uniform_(self.weight, math.sqrt(1.0 / (k * k * cin)), generator)
        self.bias.zero_()

    def forward(self, x):
        k = self.weight.shape[-1]
        geometry = dict(stride=self.stride, padding=k // 2,
                        output_padding=self.stride - 1)
        if self.dtype == torch.float32:
            return F.conv_transpose2d(x, self.weight, self.bias, **geometry)
        w, b = _cast_parameters(self)
        return bf16_conv(F.conv_transpose2d, x.to(self.dtype), w,
                         **geometry) + b.view(-1, 1, 1)

    def fuses_with(self, nxt) -> bool:
        return (isinstance(nxt, GDN) and self.stride == 2
                and self.weight.shape[-1] == 5)

    def forward_fused(self, gdn_layer, x):
        """This deconv and the (I)GDN after it as one deconv_igdn launch
        (float32 parameters, rounded to bf16 values in a bf16 layer)."""
        taps, bias = _derived(self, "taps", lambda: (
            deconv_weight_taps(_rounded(self.weight, self.dtype)),
            _rounded(self.bias, self.dtype)), self.weight, self.bias)
        gamma, beta = gdn_layer.kernel_parameters()
        y = deconv_igdn(x.to(self.dtype).permute(0, 2, 3, 1), taps, bias,
                        gamma, beta, "igdn" if gdn_layer.inverse else "gdn")
        return y.permute(0, 3, 1, 2)


class GDN(nn.Module):
    """Generalized divisive normalization (inverse=True: IGDN).

    y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2); gamma (out, in).
    Parameters are stored in reparam space as in the JAX package and the
    reference's state_dict.
    """

    def __init__(self, channels, inverse=False, dtype=torch.float32):
        super().__init__()
        self.inverse = inverse
        self.dtype = dtype
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))

    @torch.no_grad()
    def init_parameters(self, generator):
        del generator  # deterministic init
        c = self.beta.shape[0]
        self.beta.copy_(nonneg_init(torch.ones(c)))
        self.gamma.copy_(nonneg_init(0.1 * torch.eye(c)))

    def effective(self):
        """(gamma, beta) after the non-negative reparametrisation."""
        return nonneg_forward(self.gamma), nonneg_forward(self.beta, _BETA_MIN)

    def kernel_parameters(self):
        """(gamma rounded to the layer's dtype, held in float32; beta): what
        the kernels take. beta stays float32, as JAX adds it to the float32
        product (layers.py:306-310)."""
        def make():
            gamma, beta = self.effective()
            return _rounded(gamma, self.dtype), beta
        return _derived(self, "effective", make, self.gamma, self.beta)

    def forward(self, x):
        gamma, beta = self.kernel_parameters()
        return gdn(x.to(self.dtype).permute(0, 2, 3, 1), gamma, beta,
                   self.inverse).permute(0, 3, 1, 2)


def run_layers(layers, x):
    """Apply `layers` in order to NCHW x. Under no-grad (decode, eval),
    each Deconv k5/s2 followed by a GDN runs as one fused deconv_igdn op;
    with grad enabled every layer runs on its own."""
    layers = list(layers)
    fuse = not torch.is_grad_enabled()
    i = 0
    while i < len(layers):
        layer = layers[i]
        if (fuse and isinstance(layer, Deconv) and i + 1 < len(layers)
                and layer.fuses_with(layers[i + 1])):
            x = layer.forward_fused(layers[i + 1], x)
            i += 2
        else:
            x = layer(x)
            i += 1
    return x
