"""Fused transposed conv k5/s2 + (I)GDN: kernel 2 of the port.

Replaces mmnc_tpu/ops/deconv_igdn_pallas.py:deconv_igdn_pallas (kernel
body `_kernel`) with the hand-written CUDA kernel `csrc/deconv_igdn.cu`.
On the H100 the 100- and 50-channel stages are bound by f32 FMAs and the
3-channel ones by bytes; the kernel tiles the output spatially (a 1-pixel
input halo per tile, all Cout channels of a pixel in one block so the
(I)GDN epilogue stays on chip) and writes the interleaved output once.
See the source for the design. Forward only: the decode path runs it
under no-grad, training keeps the unfused autograd path.

`deconv_igdn(x, w, b, gamma, beta, mode)` mirrors `deconv_igdn_pallas`:
x (B, H, W, Cin) NHWC, w (5, 5, Cin, Cout) in the JAX tap layout (the
spatial flip of torch's ConvTranspose2d weight, see `deconv_weight_taps`),
b (Cout,), gamma (Cout, Cout) [out, in], beta (Cout,); mode is "igdn",
"gdn" or None. A CPU tensor takes the plain version
`deconv_igdn_plain`; a CUDA tensor launches the kernel or raises.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .gdn import gdn_plain

_MODES = {None: 0, "igdn": 1, "gdn": 2}


def deconv_weight_taps(weight):
    """torch ConvTranspose2d weight (Cin, Cout, 5, 5) -> (5, 5, Cin, Cout)
    in the JAX cross-correlation layout the kernel indexes."""
    return weight.flip(2, 3).permute(2, 3, 0, 1).contiguous()


def _check_mode(mode, gamma, beta):
    if mode not in _MODES:
        raise ValueError(f"mode must be 'igdn', 'gdn' or None, got {mode!r}")
    if mode is not None and (gamma is None or beta is None):
        raise ValueError(f"mode {mode!r} needs gamma and beta")


def deconv_igdn_plain(x, w, b, gamma=None, beta=None, mode="igdn"):
    """F.conv_transpose2d followed by the plain (I)GDN, NHWC in and out."""
    _check_mode(mode, gamma, beta)
    weight = w.permute(2, 3, 0, 1).flip(2, 3)  # back to (Cin, Cout, 5, 5)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, b, stride=2,
                           padding=2, output_padding=1).permute(0, 2, 3, 1)
    if mode is None:
        return y
    c = y.shape[-1]
    out = gdn_plain(y.reshape(-1, c), gamma, beta, inverse=(mode == "igdn"))
    return out.view(y.shape)


@functools.cache
def _entry():
    fn = _build.load("deconv_igdn").mmnc_deconv_igdn_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_SMS = 132  # H100 SXM streaming multiprocessors
_WIDE_TILES = ((4, 4), (2, 4), (1, 4))


def tile_shape(b: int, h: int, w: int, cout: int):
    """(TA, TB) input positions per block.

    Wide Cout: the largest of 4x4, 2x4, 1x4 that gives at least one block
    per SM, else 1x4 (the small latent stages need the blocks more than the
    weight reuse of a tall tile); inputs narrower than 4 take 1x1 tiles and
    one column per thread. Narrow Cout: 8x16, so 256 threads have (parity,
    row, column group, channel) items. Never taller or wider than the
    input. (Chosen from chip_smoke.py runs on an H100 at the decode
    stages' shapes; see PERF.md.)"""
    if cout < 32:
        return min(8, h), min(16, w)
    if w < 4:
        return 1, 1
    for ta, tb in _WIDE_TILES:
        if b * -(-h // ta) * -(-w // tb) >= _SMS:
            break
    return min(ta, h), tb


def deconv_igdn_cuda(x, w, b, gamma=None, beta=None, mode="igdn"):
    """Launch csrc/deconv_igdn.cu on CUDA float32 tensors; raises otherwise."""
    _check_mode(mode, gamma, beta)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (5, 5, cin, cout) or b.shape != (cout,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    tensors = [x, w, b] + ([gamma, beta] if mode is not None else [])
    if not all(t.is_cuda and t.dtype == torch.float32 for t in tensors):
        raise ValueError("deconv_igdn_cuda takes CUDA float32 tensors")
    if mode is not None and (gamma.shape != (cout, cout)
                             or beta.shape != (cout,)):
        raise ValueError("gamma/beta do not match Cout")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if mode is None:
        gamma = beta = b  # not read by the kernel
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty((bsz, 2 * h, 2 * wd, cout), dtype=x.dtype,
                      device=x.device)
    ta, tb = tile_shape(bsz, h, wd, cout)
    rc = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
                  ta, tb, _MODES[mode],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "deconv_igdn")
    deconv_igdn_cuda.launches += 1
    return out


deconv_igdn_cuda.launches = 0


def deconv_igdn(x, w, b, gamma=None, beta=None, mode="igdn"):
    """The plain version on the CPU, else the CUDA kernel (forward only)."""
    if x.device.type == "cpu":
        return deconv_igdn_plain(x, w, b, gamma, beta, mode)
    return deconv_igdn_cuda(x, w, b, gamma, beta, mode)
