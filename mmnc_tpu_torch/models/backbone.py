"""ScaleHyperprior backbone (mmnc_tpu/models/backbone.py:42-157), NCHW.

* g_a: 4x [conv5x5 s2 (+ GDN except last)], N -> N -> N -> N -> M
* g_s: 4x [deconv5x5 s2 (+ IGDN except last)], M -> N -> N -> N -> N;
  under no-grad its 3 deconv->IGDN pairs are fused deconv_igdn launches
  and the last deconv stays a plain conv_transpose2d. Built only with
  `use_gs` (the mixed variant); without it synthesis returns y_hat
* h_a (applied to |y|): conv3x3 s1 -> ReLU -> conv5x5 s2 -> ReLU -> conv5x5 s2
* h_s: deconv s2 -> ReLU -> deconv s2 -> ReLU -> conv3x3 s1 -> ReLU

`forward(..., legacy_broadcast=True)` keeps the reference's as-built
likelihood geometry, where h_s's scales (B,M,4,4) broadcast against y
(B,M,1,1) at 256 px; False corner-crops the scales to y. It is an
argument, not a module attribute, so a codec and its corrected-geometry
twin share one set of modules. The coding path always uses
the same top-left corner crop (codecs.py `_compress_device`).
"""

import torch
import torch.nn as nn

from ..entropy import gaussian_conditional as gc
from ..entropy.entropy_bottleneck import EntropyBottleneck
from ..ops.bound import abs_
from ..ops.layers import GDN, Conv, Deconv, run_layers


class AnalysisTransform(nn.Sequential):
    def __init__(self, n, m, dtype=torch.float32):
        super().__init__(
            Conv(n, n, dtype=dtype), GDN(n, dtype=dtype),
            Conv(n, n, dtype=dtype), GDN(n, dtype=dtype),
            Conv(n, n, dtype=dtype), GDN(n, dtype=dtype),
            Conv(n, m, dtype=dtype))

    def forward(self, x):
        return run_layers(self, x)


class SynthesisTransform(nn.Sequential):
    def __init__(self, m, n, out, dtype=torch.float32):
        super().__init__(
            Deconv(m, n, dtype=dtype), GDN(n, inverse=True, dtype=dtype),
            Deconv(n, n, dtype=dtype), GDN(n, inverse=True, dtype=dtype),
            Deconv(n, n, dtype=dtype), GDN(n, inverse=True, dtype=dtype),
            Deconv(n, out, dtype=dtype))

    def forward(self, x):
        return run_layers(self, x)


class HyperAnalysis(nn.Sequential):
    def __init__(self, m, n, dtype=torch.float32):
        super().__init__(Conv(m, n, 3, 1, dtype), nn.ReLU(),
                         Conv(n, n, dtype=dtype), nn.ReLU(),
                         Conv(n, n, dtype=dtype))


class HyperSynthesis(nn.Sequential):
    def __init__(self, n, m, dtype=torch.float32):
        super().__init__(Deconv(n, n, dtype=dtype), nn.ReLU(),
                         Deconv(n, n, dtype=dtype), nn.ReLU(),
                         Conv(n, m, 3, 1, dtype), nn.ReLU())


class ScaleHyperprior(nn.Module):
    """in_channels -> latent y (M channels) with a hyperprior over scales.
    `dtype`: the activations' type in g_a, g_s, h_a and h_s; the entropy
    models compute in float32 (entropy/*.py)."""

    def __init__(self, in_channels, latent_channels, use_gs=True,
                 dtype=torch.float32):
        super().__init__()
        n, m = in_channels, latent_channels
        self.use_gs = use_gs
        self.g_a = AnalysisTransform(n, m, dtype)
        if use_gs:
            self.g_s = SynthesisTransform(m, n, n, dtype)
        self.h_a = HyperAnalysis(m, n, dtype)
        self.h_s = HyperSynthesis(n, m, dtype)
        self.entropy_bottleneck = EntropyBottleneck(n)

    def analyze(self, x):
        """Deterministic encode path: x -> (y, z)."""
        y = self.g_a(x)
        return y, self.h_a(abs_(y))

    def hyper_synthesize(self, z_hat):
        return self.h_s(z_hat)

    def synthesize(self, y_hat):
        return self.g_s(y_hat) if self.use_gs else y_hat

    def forward(self, x, training: bool = False, noise=None,
                legacy_broadcast: bool = True):
        """-> dict(x_hat, likelihoods={y, z}, y_hat, z_hat).

        Training quantizes by additive noise: `noise` is {"z": .., "y": ..}
        of U(-1/2, 1/2), NCHW in z's and y's shapes; eval rounds (z around
        the medians)."""
        noise = noise if training else {}
        y, z = self.analyze(x)
        z_hat, z_lik = self.entropy_bottleneck(z, training, noise.get("z"))
        scales = self.h_s(z_hat)
        if not legacy_broadcast:
            scales = scales[:, :, :y.shape[2], :y.shape[3]]
        y_hat = gc.quantize(y, noise.get("y"), training)
        y_lik = gc.likelihood(y_hat, scales)
        return {"x_hat": self.synthesize(y_hat),
                "likelihoods": {"y": y_lik, "z": z_lik},
                "y_hat": y_hat, "z_hat": z_hat}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()
