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

import torch.nn as nn

from ..entropy import gaussian_conditional as gc
from ..entropy.entropy_bottleneck import EntropyBottleneck
from ..ops.bound import abs_
from ..ops.layers import GDN, Conv, Deconv, run_layers


class AnalysisTransform(nn.Sequential):
    def __init__(self, n, m):
        super().__init__(Conv(n, n), GDN(n), Conv(n, n), GDN(n),
                         Conv(n, n), GDN(n), Conv(n, m))

    def forward(self, x):
        return run_layers(self, x)


class SynthesisTransform(nn.Sequential):
    def __init__(self, m, n, out):
        super().__init__(Deconv(m, n), GDN(n, inverse=True),
                         Deconv(n, n), GDN(n, inverse=True),
                         Deconv(n, n), GDN(n, inverse=True),
                         Deconv(n, out))

    def forward(self, x):
        return run_layers(self, x)


class HyperAnalysis(nn.Sequential):
    def __init__(self, m, n):
        super().__init__(Conv(m, n, 3, 1), nn.ReLU(), Conv(n, n), nn.ReLU(),
                         Conv(n, n))


class HyperSynthesis(nn.Sequential):
    def __init__(self, n, m):
        super().__init__(Deconv(n, n), nn.ReLU(), Deconv(n, n), nn.ReLU(),
                         Conv(n, m, 3, 1), nn.ReLU())


class ScaleHyperprior(nn.Module):
    """in_channels -> latent y (M channels) with a hyperprior over scales."""

    def __init__(self, in_channels, latent_channels, use_gs=True):
        super().__init__()
        n, m = in_channels, latent_channels
        self.use_gs = use_gs
        self.g_a = AnalysisTransform(n, m)
        if use_gs:
            self.g_s = SynthesisTransform(m, n, n)
        self.h_a = HyperAnalysis(m, n)
        self.h_s = HyperSynthesis(n, m)
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
