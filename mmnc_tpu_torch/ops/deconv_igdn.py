"""Fused transposed conv k5/s2 + (I)GDN: kernel 2 of the port.

Replaces mmnc_tpu/ops/deconv_igdn_pallas.py:deconv_igdn_pallas (kernel
body `_kernel`) with the hand-written CUDA kernel `csrc/deconv_igdn.cu`.
On the H100 the 100- and 50-channel stages are bound by f32 FMAs and the
3-channel ones by bytes. The kernel has four variants, picked per shape
and type by `launch_plan`:
- "tiled" (every stage off the split kernel): a block owns one output
  parity plane of a `tile_shape` tile of input positions with all Cout
  channels (all four planes where Cout <= 4), so the (I)GDN epilogue
  stays on chip; tiles are picked so a launch has at least min(132, B x
  4 x ceil(H W / 8)) blocks. It stages the planes' weight taps for chunks
  of Cin into shared memory by cp.async, double buffered, beside the
  input tile and gamma; a thread keeps up to 8 positions along a tile row
  x 4 output channels in registers, and while a launch has few threads
  they split Cin into slices added in order (`tiled_config`);
- "tiled_l2", where gamma and the stages fit beside no tile (Cout above
  about 225): one block per `wide_tiles` tile and all four parities, the
  weight and gamma read from L2;
- "split", for the latent stages (Cout 32-128, a multiple of 4) whose
  tiles would leave most SMs idle: a thread-block cluster per tile whose
  blocks take slices of Cin and add their partial sums in rank order
  through distributed shared memory;
- "tiled_mma", for bf16 x in place of "tiled" (Cout above 4, tiles a
  multiple of 8 wide, `mma_tile_shape`): the same blocks, their sum an
  implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 products,
  which are exact, float32 sums), the input tile and the weight stages
  in bf16 (the weights converted through registers as they are staged)
  and read by ldmatrix; the same epilogue (`tiled_mma_config`).
All write the interleaved output once, and each output's sum runs in an
order set by the shape and the plan alone: two launches are bitwise
equal. See the source for the design. Forward only: the decode path runs
it under no-grad, training keeps the unfused autograd path.

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
bf16 chain. The launch plan depends on x's type only where bf16 takes the
tensor cores: float32 stays exact, off them.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .gdn import gdn_plain

_MODES = {None: 0, "igdn": 1, "gdn": 2}
# the entry point's variant argument where splits == 1
_VARIANTS = {"tiled": 0, "tiled_l2": 1, "tiled_mma": 2}


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
# the tiled kernel's limits (csrc/deconv_igdn.cu): threads a block, Cin
# slices, Cin channels a stage, and the shared memory that leaves room for
# a second block on the SM
TILED_MAX_THREADS, MAX_SLICES, MAX_TILED_CHUNK = 256, 16, 32
HALF_SMEM = 112 * 1024
# threads a tiled launch aims for (32 warps an SM); below that, Cin slices
# add threads to the blocks
FILL_THREADS = 132 * 1024
# tiles of the tiled kernel, largest first
TILES = ((16, 32), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2),
         (1, 2), (1, 1))
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def parity_taps(d: int, p0: int, t: int, n: int):
    """(t_lo, count): the taps t_lo.. of parity d (kernel indices 2t + d,
    t < 3 - d, at input offset t + d - 1) that reach an axis of length n
    from the tile positions [p0, p0 + t) (csrc/deconv_igdn.cu:parity_taps)."""
    last = min(p0 + t, n) - 1
    hits = [tt for tt in range(3 - d)
            if p0 + tt + d - 1 <= n - 1 and last + tt + d - 1 >= 0]
    return (hits[0] if hits else 0), len(hits)


def max_parity_taps(n: int, t: int, d: int) -> int:
    """The most taps parity d of a tile of t positions reads along an axis
    of length n, over the tiles."""
    return max(parity_taps(d, p0, t, n)[1] for p0 in range(0, n, t))


def planes(cout: int) -> int:
    """Parity planes a tiled block owns: all four where Cout <= 4 (one
    channel quad: the planes share the input tile), else one."""
    return 4 if cout <= 4 else 1


class TiledConfig(NamedTuple):
    """The tiled kernel's plan of one launch (csrc/deconv_igdn.cu:
    TiledPlan): positions a thread, Cin slices, Cin channels a stage,
    weight rows a stage, threads a block, dynamic shared memory."""
    p: int
    slices: int
    chunk: int
    nv: int
    threads: int
    smem_bytes: int


def tiled_smem_bytes(ta: int, tb: int, cin: int, cout: int, nv: int,
                     slices: int, chunk: int) -> int:
    """Dynamic shared memory of one tiled block: the weight stages (two,
    one where a chunk holds all of Cin; after the main loop the slices'
    partial sums, y and y^2 in their place, if larger),
    the input tile + halo (rounded up to 4 floats), gamma (transposed,
    rows padded to Cp = 4 ceil(Cout / 4)) and beta (Cp), whatever the mode
    (csrc/deconv_igdn.cu:tiled_smem_floats mirrors it)."""
    cp, npos = 4 * _cdiv(cout, 4), ta * tb
    stages = (2 if chunk < cin else 1) * nv * chunk * cp
    ys = planes(cout) * npos * cp * (slices + 2 if slices > 1 else 2)
    return 4 * (max(stages, ys) + 4 * _cdiv((ta + 2) * (tb + 2) * cin, 4)
                + cout * cp + cp)


@functools.cache
def tiled_config(b: int, h: int, w: int, cin: int, cout: int, ta: int,
                 tb: int):
    """The tiled kernel's plan for ta x tb tiles of b h x w inputs, or
    None where none fits (csrc/deconv_igdn.cu:tiled_plan):

    - p positions a thread, along a tile row: the largest of 8, 4, 2, 1
      that divides tb and leaves at least 32 (position group, channel
      quad) threads;
    - slices of Cin: doubled while the launch has fewer than FILL_THREADS
      threads, the block keeps to 256 and a slice to 4 channels, up to
      16;
    - chunk of Cin a stage: the largest of min(Cin, 32), 16, 8 (not below
      min(Cin, 8)) within HALF_SMEM, else the largest of those, 4, 2, 1
      within MAX_SMEM;
    - nv weight rows a stage, the most taps a block's planes read.
    Nothing here depends on the mode, so neither does the order of sums."""
    if min(ta, tb, cin, cout) < 1:
        return None
    npos, cq, nq = ta * tb, _cdiv(cout, 4), planes(cout)
    p = 8
    while p > 1 and (tb % p or nq * npos // p * cq < 32):
        p //= 2
    base = nq * npos // p * cq
    if base > TILED_MAX_THREADS:
        return None
    blocks, slices = tiled_blocks(b, h, w, ta, tb, cout), 1
    while (blocks * slices * base < FILL_THREADS and 2 * slices <= MAX_SLICES
           and 2 * slices * base <= TILED_MAX_THREADS and 8 * slices <= cin):
        slices *= 2
    taps = [max_parity_taps(h, ta, q >> 1) * max_parity_taps(w, tb, q & 1)
            for q in range(4)]
    nv = sum(taps) if nq == 4 else max(taps)
    first = min(cin, MAX_TILED_CHUNK)
    sizes = [c for c in (first, 16, 8, 4, 2, 1) if c <= first]
    for limit, least in ((HALF_SMEM, min(cin, 8)), (MAX_SMEM, 1)):
        for c in sizes:
            smem = tiled_smem_bytes(ta, tb, cin, cout, nv, slices, c)
            if c >= least and smem <= limit:
                return TiledConfig(p, slices, c, nv,
                                   _cdiv(slices * base, 32) * 32, smem)
    return None


def tiled_blocks(b: int, h: int, w: int, ta: int, tb: int, cout: int) -> int:
    """Blocks of a tiled launch: one per image, tile and parity plane, or
    per image and tile where a block owns the four planes."""
    return b * 4 // planes(cout) * _cdiv(h, ta) * _cdiv(w, tb)


@functools.cache
def tile_shape(b: int, h: int, w: int, cin: int, cout: int):
    """(TA, TB) input positions per tiled block, or None where no tile
    fits: the largest of TILES (each no taller or wider than the input)
    whose launch has at least min(132, B x 4 x ceil(H W / 8)) blocks, so
    that while a launch is short of one block per SM no block owns more
    than 8 positions of a parity plane, and whose plan fits
    (`tiled_config`)."""
    need = min(_SMS, b * 4 * _cdiv(h * w, 8))
    for ta, tb in TILES:
        ta, tb = min(ta, h), min(tb, w)
        if (tiled_blocks(b, h, w, ta, tb, cout) >= need
                and tiled_config(b, h, w, cin, cout, ta, tb)):
            return ta, tb
    return None


def wide_tiles(b: int, h: int, w: int):
    """(TA, TB) of the kernel with gamma in L2, one block per tile: the
    largest of 4x4, 2x4, 1x4 that gives at least one block per SM, else
    1x4; inputs narrower than 4 take 1x1 tiles and one column per thread.
    The split kernel is taken only where these tiles give fewer blocks
    than SMs."""
    if w < 4:
        return 1, 1
    for ta, tb in _WIDE_TILES:
        if b * _cdiv(h, ta) * _cdiv(w, tb) >= _SMS:
            break
    return min(ta, h), tb


def l2_smem_bytes(ta: int, tb: int, cin: int, cout: int, mode="igdn",
                  gamma=False) -> int:
    """Dynamic shared memory of one block of the kernel with gamma in L2:
    the input tile + halo, the tile's pre-activations and beta
    (csrc/deconv_igdn.cu mirrors it); with gamma=True plus Cout x Cout of
    gamma, the count by which the split kernel is chosen."""
    floats = (ta + 2) * (tb + 2) * cin + 4 * ta * tb * cout
    if mode is not None:
        floats += cout + (cout * cout if gamma else 0)
    return 4 * floats


# the tensor-core kernel's limits (csrc/deconv_igdn.cu): warps a block, the
# warps a block aims for (it splits N into groups below that), n8 tiles a
# warp, positions a thread of its epilogue (tb must be a multiple), and
# (row, column pair) items of a weight chunk a thread stages, at most
MMA_MAX_WARPS, MMA_MIN_WARPS, MMA_MAX_NT, MMA_P = 16, 8, 8, 8
MMA_ITEMS = 2
# blocks a tensor-core launch needs, where its shape has them: every block
# stages the plane's whole weight, so 128 blocks of twice the positions
# beat 256 on the H100 (a tile sweep of the planned shapes, PERF.md §6)
MMA_MIN_BLOCKS = 128


class MmaConfig(NamedTuple):
    """The tensor-core kernel's plan of one launch (csrc/deconv_igdn.cu:
    MmaPlan): n8 tiles a warp, N groups, Cin channels a stage, weight rows
    a stage, threads a block, staged (row, column pair) items a thread (1
    or MMA_ITEMS), dynamic shared memory, and the padded strides it
    implies, in bf16 values: a stage row (nb) and an input tile row (xs),
    each an odd number of 16 bytes."""
    nt: int
    ng: int
    chunk: int
    nv: int
    threads: int
    items: int
    smem_bytes: int
    nb: int
    xs: int


def stage_row(np_: int) -> int:
    """bf16 values a row of a tensor-core weight stage takes: N, plus 8
    where N / 8 is even, so that rows lie an odd number of 16 bytes apart
    (ldmatrix's 8 rows in distinct banks)."""
    return np_ + (0 if np_ // 8 % 2 else 8)


def mma_smem_bytes(ta: int, tb: int, cin: int, cout: int, np_: int, nv: int,
                   chunk: int) -> int:
    """Dynamic shared memory of one tensor-core block: the bf16 weight
    stages (two, one where a chunk holds all of Cin), rows of
    `stage_row(np_)` values (y and y^2 in float32 in their place after the
    main loop, if larger; y^2 skewed by 4 floats a group of MMA_P
    positions), the bf16 input tile + halo, rows of 16 ceil(Cin / 16) + 8
    values, gamma (transposed, rows padded to Cp) and beta (Cp), whatever
    the mode (csrc/deconv_igdn.cu:mma_smem_bytes)."""
    cp, npos = 4 * _cdiv(cout, 4), ta * tb
    stages = 2 * (2 if chunk < cin else 1) * nv * chunk * stage_row(np_)
    ys = 4 * (2 * npos * cp + npos // MMA_P * 4)
    return (max(stages, ys)
            + 2 * (ta + 2) * (tb + 2) * (16 * _cdiv(cin, 16) + 8)
            + 4 * (cout * cp + cp))


@functools.cache
def tiled_mma_config(h: int, w: int, cin: int, cout: int, ta: int, tb: int):
    """The tensor-core kernel's plan for ta x tb tiles of h x w inputs, or
    None where it has none (tb not a multiple of MMA_P, Cout <= 4, more
    than MMA_MAX_WARPS warps, or no chunk fits; csrc/deconv_igdn.cu:
    mma_plan):

    - M tiles: ceil(ta tb / 16), one a warp; N groups ng: the fewest with
      at most MMA_MAX_NT n8 tiles a warp that give MMA_MIN_WARPS warps;
    - nt = ceil(ceil(Cout / 8) / ng) n8 tiles a warp (N = 8 nt ng), then
      ng = ceil(ceil(Cout / 8) / nt), so that no group lies wholly past
      Cout;
    - chunk of Cin a stage, a multiple of 16: the largest from 16 ceil(Cin
      / 16) down whose chunk x N / 2 (row, column pair) items come to at
      most MMA_ITEMS a thread and that fits HALF_SMEM, else MAX_SMEM;
    - nv weight rows a stage, the most taps a plane reads.
    Nothing here depends on the mode, so neither does the order of sums."""
    if min(ta, tb, cin) < 1 or tb % MMA_P or cout <= 4:
        return None
    mt, ntiles = _cdiv(ta * tb, 16), _cdiv(cout, 8)
    ng = _cdiv(ntiles, MMA_MAX_NT)
    while mt * ng < MMA_MIN_WARPS and ng < ntiles:
        ng += 1
    nt = _cdiv(ntiles, ng)
    ng = _cdiv(ntiles, nt)  # no group wholly past Cout
    if mt * ng > MMA_MAX_WARPS:
        return None
    nv = max(max_parity_taps(h, ta, q >> 1) * max_parity_taps(w, tb, q & 1)
             for q in range(4))
    kx, threads = 16 * _cdiv(cin, 16), 32 * mt * ng
    for limit in (HALF_SMEM, MAX_SMEM):
        for chunk in range(kx, 0, -16):
            smem = mma_smem_bytes(ta, tb, cin, cout, 8 * nt * ng, nv, chunk)
            items = chunk * 4 * nt * ng
            if items <= MMA_ITEMS * threads and smem <= limit:
                return MmaConfig(nt, ng, chunk, nv, threads,
                                 _cdiv(items, threads), smem,
                                 stage_row(8 * nt * ng), kx + 8)
    return None


@functools.cache
def mma_tile_shape(b: int, h: int, w: int, cin: int, cout: int):
    """(TA, TB) of the tensor-core kernel, or None: the largest of TILES
    (each no taller or wider than the input) whose launch has at least
    min(MMA_MIN_BLOCKS, B x 4 x ceil(H W / 8)) blocks, among those whose
    width is a multiple of MMA_P and whose plan fits
    (`tiled_mma_config`)."""
    need = min(MMA_MIN_BLOCKS, b * 4 * _cdiv(h * w, 8))
    for ta, tb in TILES:
        ta, tb = min(ta, h), min(tb, w)
        if (tiled_blocks(b, h, w, ta, tb, cout) >= need
                and tiled_mma_config(h, w, cin, cout, ta, tb)):
            return ta, tb
    return None


@functools.cache
def launch_plan(b: int, h: int, w: int, cin: int, cout: int,
                dtype=torch.float32):
    """(variant, TA, TB, splits) for one launch on x of `dtype`.

    "split": the latent stages, where `wide_tiles` give fewer blocks than
    SMs (Cout >= 32, a multiple of 4, at most 128, and those tiles with
    gamma within MAX_SMEM): a cluster of `splits` blocks owns each square
    tile of SPLIT_TILES (no larger than the input) and each block takes a
    slice of Cin (`cin_slices`). Of the (tile, splits) pairs with at most
    _SPLIT_MAX_BLOCKS blocks, the one with the most blocks wins, the larger
    tile on a tie (fewer weight reads). "tiled": `tile_shape`'s tiles,
    splits 1. "tiled_l2": where no tiled plan fits (Cout above about 225),
    `wide_tiles`. "tiled_mma": for bf16 x, in place of "tiled" where the
    tensor-core kernel has tiles (`mma_tile_shape`: Cout above 4, inputs
    at least 8 wide). With float32 x the plan is what it was before the
    tensor-core kernel: float32 stays exact, off the tensor cores."""
    wa, wb = wide_tiles(b, h, w)
    if (l2_smem_bytes(wa, wb, cin, cout, gamma=True) <= MAX_SMEM
            and 32 <= cout <= _SPLIT_MAX_COUT and cout % 4 == 0
            and b * _cdiv(h, wa) * _cdiv(w, wb) < _SMS):
        best = None
        for t in SPLIT_TILES:
            if t > 1 and t > min(h, w):
                continue
            tiles = b * _cdiv(h, t) * _cdiv(w, t)
            for s in SPLITS:
                blocks = tiles * s
                if blocks <= _SPLIT_MAX_BLOCKS and (best is None
                                                    or blocks > best[0]):
                    best = (blocks, t, s)
        if best is not None:
            _, t, s = best
            return "split", t, t, s
    tile = tile_shape(b, h, w, cin, cout)
    if tile is None:
        return "tiled_l2", wa, wb, 1
    if dtype == torch.bfloat16:
        mma = mma_tile_shape(b, h, w, cin, cout)
        if mma is not None:
            return ("tiled_mma", *mma, 1)
    return ("tiled", *tile, 1)


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
    against the other at the same shape); a plan with no kernel, or
    "tiled_mma" with float32 x, raises."""
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
    variant, ta, tb, splits = plan or launch_plan(bsz, h, wd, cin, cout,
                                                  x.dtype)
    if variant == "split":
        if (splits not in SPLITS or ta != tb or ta not in SPLIT_TILES
                or cout > _SPLIT_MAX_COUT or cout % 4):
            raise ValueError(f"plan {plan}: no split kernel for it")
        # its bulk copies start on 16-byte boundaries: a tensor whose data
        # does not (a view at an odd offset) is copied to one that does
        w, gamma, beta = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (w, gamma, beta))
    elif variant == "tiled":
        if splits != 1 or not tiled_config(bsz, h, wd, cin, cout, ta, tb):
            raise ValueError(f"plan {plan}: no tiled kernel for it")
    elif variant == "tiled_mma":
        if x.dtype != torch.bfloat16:
            raise ValueError(f"plan {plan}: the tensor-core kernel takes "
                             f"bf16 x, not {x.dtype}")
        if splits != 1 or not tiled_mma_config(h, wd, cin, cout, ta, tb):
            raise ValueError(f"plan {plan}: no tensor-core kernel for it")
    elif (variant != "tiled_l2" or splits != 1 or min(ta, tb) < 1
          or l2_smem_bytes(ta, tb, cin, cout, mode) > MAX_SMEM):
        raise ValueError(f"plan {plan}: no kernel for it")
    rc = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
                  ta, tb, splits if variant == "split" else 1, _MODES[mode],
                  _VARIANTS.get(variant, 0), int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "deconv_igdn")
    deconv_igdn_cuda.launches += 1
    deconv_igdn_cuda.mma_launches += variant == "tiled_mma"
    return out


# launches, and those of them on the tensor cores ("tiled_mma")
deconv_igdn_cuda.launches = deconv_igdn_cuda.mma_launches = 0


def deconv_igdn(x, w, b, gamma=None, beta=None, mode="igdn"):
    """The plain version on the CPU, else the CUDA kernel (forward only)."""
    if x.device.type == "cpu":
        return deconv_igdn_plain(x, w, b, gamma, beta, mode)
    return deconv_igdn_cuda(x, w, b, gamma, beta, mode)
