"""Fused transposed conv k5/s2 + (I)GDN: kernel 2 of the port.

Replaces mmnc_tpu/ops/deconv_igdn_pallas.py:deconv_igdn_pallas (kernel
body `_kernel`) with the hand-written CUDA kernel `csrc/deconv_igdn.cu`.
On the H100 the 100- and 50-channel stages are bound by f32 FMAs and the
3-channel ones by bytes. The kernel has two variants, picked per shape by
`launch_plan`: "tiled" tiles the output spatially (a 1-pixel input halo
per tile, all Cout channels of a pixel in one block so the (I)GDN epilogue
stays on chip; "tiled_l2", the same with gamma left in global memory, for
Cout too wide to hold Cout x Cout of gamma beside the tile); "split", for
the latent stages whose tiles would leave
most SMs idle, gives each tile to a thread-block cluster whose blocks take
slices of Cin and add their partial sums in rank order through
distributed shared memory. Both write the interleaved output once. See
the source for the design. Forward only: the decode path runs it under
no-grad, training keeps the unfused autograd path.

`deconv_igdn(x, w, b, gamma, beta, mode)` mirrors `deconv_igdn_pallas`:
x (B, H, W, Cin) NHWC, w (5, 5, Cin, Cout) in the JAX tap layout (the
spatial flip of torch's ConvTranspose2d weight, see `deconv_weight_taps`),
b (Cout,), gamma (Cout, Cout) [out, in], beta (Cout,); mode is "igdn",
"gdn" or None. A CPU tensor takes the plain version
`deconv_igdn_plain`; a CUDA tensor launches the kernel or raises.

bfloat16: x (and the output) may be bf16; w, b, gamma and beta stay
float32 (the bf16 model's layers hand over values rounded to bf16,
`ops/layers.py`). The kernel sums in float32, rounds y before the
epilogue as the unfused chain does (the sum, then + b) and the output
once at the store; `deconv_igdn_plain` is the JAX package's unfused
bf16 chain. The launch
plan does not depend on x's type: the staged input tile is float32 in
either.
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


def bf16_conv(conv, x, w, **geometry):
    """`conv` (F.conv2d or F.conv_transpose2d) of bf16 x and w, without
    bias: float32 sums rounded once to bf16, as JAX's bf16 convolution
    (mmnc_tpu/ops/layers.py:232, 250). On the CUDA card this is cuDNN's
    bf16 convolution. On the CPU it runs in float32 on the bf16 values and
    rounds the result: torch's CPU bf16 convolution gave a non-finite
    weight gradient now and then (in a fresh process's first backward)
    for h_a's 5x5 stride-2 convolutions of a 1x1 input."""
    if x.device.type == "cpu":
        return conv(x.float(), w.float(), **geometry).to(x.dtype)
    return conv(x, w, **geometry)


def deconv_igdn_plain(x, w, b, gamma=None, beta=None, mode="igdn"):
    """F.conv_transpose2d followed by the plain (I)GDN, NHWC in and out.

    For bf16 x, JAX's unfused chain (mmnc_tpu/ops/layers.py:241-251, then
    its GDN): the transposed conv of x and w rounded to bf16 (its output
    rounded), + b rounded to bf16 (rounded again), then `gdn_plain`."""
    _check_mode(mode, gamma, beta)
    weight = w.permute(2, 3, 0, 1).flip(2, 3)  # back to (Cin, Cout, 5, 5)
    x = x.permute(0, 3, 1, 2)
    if x.dtype != torch.bfloat16:
        y = F.conv_transpose2d(x, weight, b, stride=2, padding=2,
                               output_padding=1)
    else:
        y = bf16_conv(F.conv_transpose2d, x, weight.to(x.dtype), stride=2,
                      padding=2, output_padding=1) + b.to(x.dtype).view(
                          -1, 1, 1)
    y = y.permute(0, 2, 3, 1)
    if mode is None:
        return y
    c = y.shape[-1]
    out = gdn_plain(y.reshape(-1, c), gamma, beta, inverse=(mode == "igdn"))
    return out.view(y.shape)


@functools.cache
def _entry():
    fn = _build.load("deconv_igdn").mmnc_deconv_igdn_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_SMS = 132  # H100 SXM streaming multiprocessors
# dynamic shared memory a block may use (csrc/deconv_igdn.cu:kMaxSmem)
MAX_SMEM = 227 * 1024 - 1024
_WIDE_TILES = ((4, 4), (2, 4), (1, 4))
SPLIT_TILES = (4, 2, 1)  # square tiles the split kernel is built for
SPLITS = (8, 4, 2)  # cluster sizes up to the portable limit of 8
# one thread per (parity, position group, 4 channels), and gamma beside the
# weight chunks in shared memory
_SPLIT_MAX_COUT = 128
# Blocks of one split launch: half the SMs, so that clusters of up to 8
# blocks (one per SM, for their shared memory) run in one wave whatever the
# GPC a cluster lands on. 128 blocks in clusters of 4 ran in two waves on
# the H100 (PERF.md).
_SPLIT_MAX_BLOCKS = _SMS // 2


def tile_shape(b: int, h: int, w: int, cout: int):
    """(TA, TB) input positions per block.

    Wide Cout: the largest of 4x4, 2x4, 1x4 that gives at least one block
    per SM, else 1x4; inputs narrower than 4 take 1x1 tiles and one column
    per thread. The 1x4 and 1x1 tiles serve the shapes `launch_plan` keeps
    off the split kernel (Cout not a multiple of 4 or above 128, or more
    tiles than one split wave holds) and a forced plan. Narrow Cout: 8x16, so 256 threads have (parity,
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


def tiled_smem_bytes(ta: int, tb: int, cin: int, cout: int,
                     gamma_l2: bool, mode="igdn") -> int:
    """Dynamic shared memory of one tiled block: the input tile + halo,
    the tile's pre-activations, beta and, unless gamma stays in global
    memory, Cout x Cout of gamma (csrc/deconv_igdn.cu mirrors it)."""
    floats = (ta + 2) * (tb + 2) * cin + 4 * ta * tb * cout
    if mode is not None:
        floats += cout + (0 if gamma_l2 else cout * cout)
    return 4 * floats


def launch_plan(b: int, h: int, w: int, cin: int, cout: int):
    """(variant, TA, TB, splits) for one launch.

    "tiled": `tile_shape`'s tiles, one block each, splits 1; "tiled_l2"
    where gamma would not fit beside such a tile in shared memory (Cout
    above about 230). "split": the
    latent stages, where those tiles give fewer blocks than SMs (Cout >= 32,
    a multiple of 4, at most 128): a cluster of `splits` blocks owns each
    square tile of SPLIT_TILES (no larger than the input) and each block
    takes a slice of Cin (`cin_slices`). Of the (tile, splits) pairs with at
    most _SPLIT_MAX_BLOCKS blocks, the one with the most blocks wins, the
    larger tile on a tie (fewer weight reads)."""
    ta, tb = tile_shape(b, h, w, cout)
    if tiled_smem_bytes(ta, tb, cin, cout, gamma_l2=False) > MAX_SMEM:
        return "tiled_l2", ta, tb, 1
    if (cout < 32 or cout > _SPLIT_MAX_COUT or cout % 4
            or b * -(-h // ta) * -(-w // tb) >= _SMS):
        return "tiled", ta, tb, 1
    best = None
    for t in SPLIT_TILES:
        if t > 1 and t > min(h, w):
            continue
        tiles = b * -(-h // t) * -(-w // t)
        for s in SPLITS:
            blocks = tiles * s
            if blocks <= _SPLIT_MAX_BLOCKS and (best is None
                                                or blocks > best[0]):
                best = (blocks, t, s)
    if best is None:  # too many tiles for one wave even unsplit
        return "tiled", ta, tb, 1
    _, t, s = best
    return "split", t, t, s


def cin_slices(cin: int, splits: int):
    """[(start, size)] of Cin per cluster rank: contiguous, the first
    cin % splits ranks one channel longer (100 over 8: 13 x 4, 12 x 4).
    The kernel computes the same slices (csrc/deconv_igdn.cu)."""
    base, rem = divmod(cin, splits)
    return [(r * base + min(r, rem), base + (r < rem)) for r in range(splits)]


def deconv_igdn_cuda(x, w, b, gamma=None, beta=None, mode="igdn", plan=None):
    """Launch csrc/deconv_igdn.cu on CUDA tensors: x float32 or bfloat16
    (the output x's type), w, b, gamma and beta float32; raises otherwise.

    `plan` overrides `launch_plan` (chip_smoke.py times one variant
    against the other at the same shape)."""
    _check_mode(mode, gamma, beta)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (5, 5, cin, cout) or b.shape != (cout,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    params = [w, b] + ([gamma, beta] if mode is not None else [])
    if not (x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)
            and all(t.is_cuda and t.dtype == torch.float32 for t in params)):
        raise ValueError("deconv_igdn_cuda takes CUDA tensors: x float32 or "
                         "bfloat16, w, b, gamma and beta float32")
    if mode is not None and (gamma.shape != (cout, cout)
                             or beta.shape != (cout,)):
        raise ValueError("gamma/beta do not match Cout")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if mode is None:
        gamma = beta = b  # not read by the kernel
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty((bsz, 2 * h, 2 * wd, cout), dtype=x.dtype,
                      device=x.device)
    variant, ta, tb, splits = plan or launch_plan(bsz, h, wd, cin, cout)
    if variant == "split":
        if (splits not in SPLITS or ta != tb or ta not in SPLIT_TILES
                or cout > _SPLIT_MAX_COUT or cout % 4):
            raise ValueError(f"plan {plan}: no split kernel for it")
        # its bulk copies start on 16-byte boundaries: a tensor whose data
        # does not (a view at an odd offset) is copied to one that does
        w, gamma, beta = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (w, gamma, beta))
    elif (variant not in ("tiled", "tiled_l2") or splits != 1
          or tiled_smem_bytes(ta, tb, cin, cout, variant == "tiled_l2",
                              mode) > MAX_SMEM):
        raise ValueError(f"plan {plan}: no kernel for it")
    rc = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
                  ta, tb, splits if variant == "split" else 1, _MODES[mode],
                  int(variant == "tiled_l2"), int(x.dtype == torch.bfloat16),
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
