"""Task-specific encoder/decoder heads (mmnc_tpu/models/heads.py:26-79).

Both are `nn.Sequential`s so their state_dict names are the reference's
`{seq}.weight` / `{seq}.beta` layout (mmnc_tpu/utils/torch_import.py:4-16).

* EncoderHead: conv3x3 s1 (in -> c/2) + GDN, then 5x [conv5x5 s2 + GDN]
  at width c — downsamples 32x.
* DecoderHead: deconv(in -> in/2)+IGDN, conv3x3+IGDN, deconv+IGDN,
  conv3x3+IGDN, deconv(-> out)+IGDN, deconv(out -> out)+IGDN, conv3x3 —
  upsamples 16x. Under no-grad its 4 deconv->IGDN pairs run as fused
  deconv_igdn launches.
* UpsampleStack (disjoint/shared only, in place of the absent g_s):
  3x [deconv(-> cc) + IGDN], then deconv(cc -> conv_channels), with
  cc = conv_channels // n_tasks — another 16x; its 3 pairs fuse too.
* UpsampledDecoderHead: a disjoint/shared output head, the upsample
  stack's 7 layers at indices 0-6 and a DecoderHead(conv_channels) at 7,
  the reference's `model.output_heads.{t}` layout
  (mmnc_tpu/utils/torch_import.py:147-157).

`dtype` is every layer's activation type (ops/layers.py).
"""

import torch
import torch.nn as nn

from ..ops.layers import GDN, Conv, Deconv, run_layers


class EncoderHead(nn.Sequential):
    def __init__(self, in_channels, conv_channels, dtype=torch.float32):
        c = conv_channels
        layers = [Conv(in_channels, c // 2, 3, 1, dtype),
                  GDN(c // 2, dtype=dtype)]
        width = c // 2
        for _ in range(5):
            layers += [Conv(width, c, dtype=dtype), GDN(c, dtype=dtype)]
            width = c
        super().__init__(*layers)

    def forward(self, x):
        return run_layers(self, x)


class DecoderHead(nn.Sequential):
    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        mid = in_channels // 2
        out = out_channels

        def igdn(c):
            return GDN(c, inverse=True, dtype=dtype)

        super().__init__(
            Deconv(in_channels, mid, dtype=dtype), igdn(mid),
            Conv(mid, mid, 3, 1, dtype), igdn(mid),
            Deconv(mid, mid, dtype=dtype), igdn(mid),
            Conv(mid, mid, 3, 1, dtype), igdn(mid),
            Deconv(mid, out, dtype=dtype), igdn(out),
            Deconv(out, out, dtype=dtype), igdn(out),
            Conv(out, out, 3, 1, dtype))

    def forward(self, x):
        return run_layers(self, x)


class UpsampleStack(nn.Sequential):
    def __init__(self, in_channels, conv_channels, n_tasks,
                 dtype=torch.float32):
        cc = conv_channels // n_tasks
        if cc < 1:
            raise ValueError(
                f"conv_channels ({conv_channels}) must be >= n_tasks "
                f"({n_tasks}) for the disjoint upsample stack")
        super().__init__(
            Deconv(in_channels, cc, dtype=dtype),
            GDN(cc, inverse=True, dtype=dtype),
            Deconv(cc, cc, dtype=dtype), GDN(cc, inverse=True, dtype=dtype),
            Deconv(cc, cc, dtype=dtype), GDN(cc, inverse=True, dtype=dtype),
            Deconv(cc, conv_channels, dtype=dtype))

    def forward(self, x):
        return run_layers(self, x)


class UpsampledDecoderHead(UpsampleStack):
    def __init__(self, in_channels, conv_channels, n_tasks, out_channels,
                 dtype=torch.float32):
        super().__init__(in_channels, conv_channels, n_tasks, dtype)
        self.append(DecoderHead(conv_channels, out_channels, dtype))
