"""(I)GDN over channel-minor rows: kernel 1 of the port.

Replaces mmnc_tpu/ops/gdn_pallas.py:_gdn_forward (kernel body
`_gdn_kernel`, reached from `gdn_pallas_2d` / `gdn_pallas`) with the
hand-written CUDA kernel `csrc/gdn.cu`. On the H100 the op sits near the
balance of bytes and f32 FMAs (C/4 FLOP per byte against a balance of 20:
C = 50 is bound by bytes, C = 100 by FMAs). The kernel reads each row
once with bulk copies into a ring of shared-memory stages that overlaps
the next tiles' copies with the current one's product, keeps gamma's
slice, beta and the squared rows in shared memory, accumulates register
micro-tiles of rows x 7 output channels in exact f32 FMAs, and writes
each output once with coalesced stores. `gdn_plan` picks its launch:
persistent blocks over row tiles, or for row counts too small to fill the
SMs and for C whose all-channel blocks do not fit in shared memory (C >
140), blocks that each take a slice of the output channels;
`gdn_cuda(..., plan=GDNPlan(...))` forces one. See the source for the
design.

`gdn(x, gamma, beta, inverse)` mirrors `gdn_pallas`: x is NHWC (or any
channels-last tensor), gamma (C, C) in [out, in] layout, beta (C,). It is
an autograd Function whose backward is the closed form of
gdn_pallas.py:85-101 (`_bwd`, the custom VJP): on a CUDA tensor the
hand-written kernel `csrc/gdn_backward.cu` (`gdn_backward_cuda`, planned by
`gdn_backward_plan`: row tiles on persistent blocks, each block's partial
dgamma and dbeta summed in a fixed order by a second launch; its three
products on the tensor cores in 3xTF32 where the plan says `mma`, else
exact float32 FMAs on the CUDA cores), on a CPU tensor its plain version
`gdn_backward_plain`. A CPU tensor takes the
plain version `gdn_plain` forward; a CUDA tensor launches the kernel or
raises.

bfloat16: x (and the output) may be bf16, gamma and beta stay float32
(the bf16 model's layer hands over gamma rounded to bf16 values,
`ops/layers.py:GDN`). The kernel computes in float32 and rounds once, at
the store; `gdn_plain` follows the JAX package's XLA chain in bf16
(mmnc_tpu/ops/layers.py:306-314), which rounds at four points; the
backward (kernel and plain version) computes in float32 and returns dx in
x's type, rounded once.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

SMS = 132  # H100 SXM streaming multiprocessors
# mirrors csrc/gdn.cu: rows per thread (kRM) of the two instantiations, a
# warp's 8 x kRM rows and 28 output channels, threads per block, ring
# stages, dynamic shared memory a block may use
RMS = (2, 8)
WARP_COLS = 28
MAX_THREADS = 256
STAGES = (2, 3, 4)
MAX_SMEM = 227 * 1024 - 1024
_SM_SMEM = 228 * 1024  # shared memory of one SM; 1 KB of it per block
# registers per thread of each kRM (ptxas -v on sm_90a, rounded up to 8)
_REGS = {2: 128, 8: 256}


class GDNPlan(NamedTuple):
    """One launch of csrc/gdn.cu: rows per thread (`rm`), rows per tile,
    output channels per block (`slice`), blocks per slice (persistent:
    each walks tiles blockIdx.x, + blocks, ...) and stages of its ring of
    row tiles."""
    rm: int
    tile_rows: int
    slice: int
    blocks: int
    stages: int


def gdn_plain(x2d, gamma, beta, inverse: bool):
    """The einsum chain: x * (r)sqrt(x^2 @ gamma^T + beta) over (N, C) rows.

    For bf16 x, JAX's chain (mmnc_tpu/ops/layers.py:306-314): x^2 rounded
    to bf16, its product with gamma rounded to bf16 accumulated in float32
    (preferred_element_type), + beta in float32, the (r)sqrt rounded to
    bf16, the product with x rounded to bf16."""
    if x2d.dtype != torch.bfloat16:
        norm = (x2d * x2d) @ gamma.t() + beta
        return x2d * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
    norm = ((x2d * x2d).float() @ gamma.to(x2d.dtype).float().t()
            + beta.float())
    scale = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return x2d * scale.to(x2d.dtype)


@functools.cache
def _entry():
    fn = _build.load("gdn").mmnc_gdn_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stride(c: int) -> int:
    cp = -(-c // 4) * 4
    return cp if (cp // 4) % 2 else cp + 4


def gdn_smem_bytes(c: int, plan: GDNPlan, elt: int = 4) -> int:
    """Dynamic shared memory of one block (csrc/gdn.cu:smem_bytes): the
    ring of raw row tiles of `elt`-byte activations, then in float32
    gamma's slice at a padded stride, the x^2 tile (also gamma's landing
    area) and beta's slice. Plans are chosen at float32's 4 bytes (the
    most a tile takes), so a plan fits in either type."""
    _, tr, sl, _, stages = plan
    x2 = max(tr * _stride(c), sl * c)
    return elt * stages * tr * c + 4 * (sl * _stride(c) + x2 + sl)


def _fits(c: int, plan: GDNPlan) -> bool:
    return gdn_smem_bytes(c, plan) <= MAX_SMEM


def threads(plan: GDNPlan) -> int:
    return plan.tile_rows // (8 * plan.rm) * (plan.slice // WARP_COLS) * 32


def resident_per_sm(c: int, plan: GDNPlan) -> int:
    """Blocks of this plan one SM holds at once, by threads, registers and
    shared memory."""
    t = threads(plan)
    regs = t * _REGS[plan.rm]
    return min(32, 2048 // t, 65536 // regs,
               _SM_SMEM // (gdn_smem_bytes(c, plan) + 1024))


def out_slices(c: int, slice_: int):
    """[(start, size)] of the output channels, one per blockIdx.y: the
    kernel's slice y covers channels y*slice .. min(C, (y+1)*slice)."""
    return [(s, min(slice_, c - s)) for s in range(0, c, slice_)]


@functools.lru_cache(maxsize=256)
def gdn_plan(n: int, c: int, variant: str = None) -> GDNPlan:
    """The launch for (n, c) rows: variant "rows" or "split", or by default
    "rows" where its blocks fit in shared memory and its tiles fill at
    least half the SMs (or C fits one warp column), else "split".

    "rows": 8 rows per thread, one slice of every output channel (C
    rounded up to 28), tiles of as many rows as 256 threads cover, at most
    as many blocks as are resident, each walking tiles. "split": 2 rows per
    thread and slices of 56 channels, one block per (tile, slice): 64-row
    tiles where they still give half the SMs a block, else 32-row tiles;
    where C is too wide for that block's shared memory, 32-row tiles, then
    28-channel slices, then 16-row tiles. Every block reads all C input
    channels, so two launches stay bitwise equal at any C.
    Stages: the most of 2-4 that the block's tiles can use and that leave
    the blocks' residency as it is at 2 stages. (Chosen from sweeps of
    plans at the path's shapes on an H100; see PERF.md.)"""
    wcols = -(-c // WARP_COLS)
    rows_tr = 64 * max(1, MAX_THREADS // 32 // wcols)
    if variant is None:
        rows_fit = _fits(c, GDNPlan(8, rows_tr, WARP_COLS * wcols, 1,
                                    STAGES[0]))
        variant = ("rows" if rows_fit and (-(-n // rows_tr) >= SMS // 2
                                           or wcols == 1) else "split")
    if variant == "rows":
        rm, tr, sl = 8, rows_tr, WARP_COLS * wcols
    elif variant == "split":
        rm, sl = 2, WARP_COLS * min(2, wcols)
        tr = 64 if -(-n // 64) * -(-c // sl) >= SMS // 2 else 32
        for t, w in ((tr, sl), (32, sl), (32, WARP_COLS), (16, WARP_COLS)):
            if _fits(c, GDNPlan(rm, t, w, 1, STAGES[0])):
                tr, sl = t, w
                break
    else:
        raise ValueError(f"gdn plan variant {variant!r}")
    tiles = -(-n // tr)
    slices = -(-c // sl)
    per_sm = resident_per_sm(c, GDNPlan(rm, tr, sl, 1, STAGES[0]))
    blocks = max(1, min(tiles, SMS * per_sm // slices))
    per_block = -(-tiles // blocks)
    stages = STAGES[0]
    for s in STAGES[1:]:
        p = GDNPlan(rm, tr, sl, 1, s)
        if (s <= per_block and _fits(c, p)
                and resident_per_sm(c, p) >= per_sm):
            stages = s
    return GDNPlan(rm, tr, sl, blocks, stages)


@functools.lru_cache(maxsize=256)
def check_plan(c: int, plan: GDNPlan) -> None:
    """Raise ValueError for a plan csrc/gdn.cu has no kernel for."""
    rm, tr, sl, blocks, stages = plan
    if (rm not in RMS or tr < 8 * rm or tr % (8 * rm) or sl < WARP_COLS
            or sl % WARP_COLS or threads(plan) > MAX_THREADS or blocks < 1
            or stages not in STAGES or not _fits(c, plan)):
        raise ValueError(f"gdn plan {tuple(plan)}: no kernel for it at C={c}")


def _max_channels() -> int:
    smallest = GDNPlan(2, 16, WARP_COLS, 1, STAGES[0])
    return max(c for c in range(1, 2048) if _fits(c, smallest))


# The widest C any plan fits (the smallest block, 16 rows x 28 channels,
# within MAX_SMEM): gdn_cuda raises above it, where the JAX package's
# chain still runs.
MAX_CHANNELS = _max_channels()


def gdn_cuda(x2d, gamma, beta, inverse: bool, plan: GDNPlan = None):
    """Launch csrc/gdn.cu on CUDA tensors: x float32 or bfloat16 (the
    output x's type), gamma and beta float32; raises on anything else.

    `plan` overrides `gdn_plan` (tests, and chip_smoke.py's check of
    every variant). The plan does not depend on x's type.

    It launches on the current stream, so under a CUDA graph capture
    (`train/step.py`) the launch is a node of the graph, and its
    alignment copy comes from the graph's memory pool; `launches` counts
    the capture once and a replay never."""
    n, c = x2d.shape
    if not (x2d.is_cuda and gamma.is_cuda and beta.is_cuda):
        raise ValueError("gdn_cuda takes CUDA tensors")
    if x2d.dtype not in (torch.float32, torch.bfloat16) \
            or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError("gdn_cuda takes float32 or bfloat16 x and float32 "
                         f"gamma and beta, got {x2d.dtype}, {gamma.dtype}, "
                         f"{beta.dtype}")
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not match C={c}")
    if c > MAX_CHANNELS:
        raise ValueError(f"gdn_cuda: no plan fits C={c} (> {MAX_CHANNELS})"
                         " in a block's shared memory")
    plan = GDNPlan(*plan) if plan is not None else gdn_plan(n, c)
    check_plan(c, plan)
    x2d, gamma, beta = x2d.contiguous(), gamma.contiguous(), beta.contiguous()
    # bulk copies start on 16-byte boundaries: a tensor whose data does not
    # (a view at an odd offset) is copied to one that does
    if x2d.data_ptr() % 16:
        x2d = x2d.clone()
    if gamma.data_ptr() % 16:
        gamma = gamma.clone()
    out = torch.empty_like(x2d)
    rc = _entry()(x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  out.data_ptr(), n, c, *plan, int(inverse),
                  int(x2d.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check_launch(rc, "gdn")
    gdn_cuda.launches += 1
    return out


gdn_cuda.launches = 0


def gdn_rows(x2d, gamma, beta, inverse: bool):
    """Forward on (N, C) rows: the plain version on the CPU, else the kernel."""
    if x2d.device.type == "cpu":
        return gdn_plain(x2d, gamma, beta, inverse)
    return gdn_cuda(x2d, gamma, beta, inverse)


# --- the backward: csrc/gdn_backward.cu -------------------------------------

# mirrors csrc/gdn_backward.cu: threads per block (256, two blocks an SM
# by the kernel's __launch_bounds__; or 512, one), rows per thread of P1
# and P2, the side of P3's square warp tiles
BWD_THREADS = (256, 512)
BWD_RMS = (2, 4)
BWD_P3 = 32
_BWD_REG_BLOCKS = 2
_BWD_SLACK = 32  # floats past gamma's padded copy that P2 may read
# the partials (blocks x C x pad4(C + 1) floats) stay at most this large:
# at C = 655 that is 39 blocks
BWD_PARTIAL_MAX_BYTES = 64 << 20
# rows above which C 64-127 takes the 512-thread blocks
BWD_WIDE_ROWS = 8192
# the tensor-core path: n8 tiles of a P1/P2 warp tile; its tiles' rows
# (multiples of the MMA's 16)
BWD_MMA_NT = 2
BWD_MMA_TILES = (16, 32, 48, 64)
# the plan gives the tensor cores every C from this one on, and narrower C
# at most BWD_MMA_NARROW_ROWS rows (above, those shapes are bound by bytes
# and the CUDA cores' tiles of 128 rows were faster)
BWD_MMA_MIN_CHANNELS = 32
BWD_MMA_NARROW_ROWS = 65536


class GDNBackwardPlan(NamedTuple):
    """One launch of csrc/gdn_backward.cu: rows per thread of its two row
    products (`rm`), rows per tile, persistent blocks (each walks tiles
    blockIdx.x, + blocks, ... and owns one slice of the partials),
    whether gamma is staged in shared memory (else read from a padded copy
    in global memory), and `split`: 0, P3 adds each tile's sums to the
    block's slice; 1-16, each of P3's warp tiles is taken by `split` warps
    (rows s, s + split, ... of every tile), whose sums stay in registers
    and are added up in phase order and stored once at the block's end
    (rm 2, gamma in shared memory, at most warps / split warp tiles, and
    their 1024 floats each within the tile buffers); `threads` 256, or
    512 (one block an SM) with a split: C 64-127, whose 9-16 warp tiles
    then get a warp each. `mma`: the three products on the tensor cores
    in 3xTF32 (`gdn_backward_mma_kernel`), where rm is 2, smem_gamma True
    and split 0 (the CUDA-core path's), tile_rows a multiple of 16 and
    P3's sums kept in registers, an m16 x (`bwd_mma_p3_nt` n8) warp tile a
    warp (`bwd_mma_p3_fits`)."""
    rm: int
    tile_rows: int
    blocks: int
    smem_gamma: bool
    split: int = 0
    threads: int = 256
    mma: bool = False


def _pad4(c: int) -> int:
    return -(-c // 4) * 4


def bwd_gamma_rows(c: int) -> int:
    """gamma's staged rows, P1's output channels: C rounded up to 28."""
    return -(-c // WARP_COLS) * WARP_COLS


def bwd_row_stride(c: int) -> int:
    """The row stride (floats) of gamma and of every tile buffer: at least
    the 28-rounded C and C + 1 (the ones column of x^2), 4 mod 8."""
    s = max(bwd_gamma_rows(c), _pad4(c + 1))
    return s if (s // 4) % 2 else s + 4


def bwd_partial_stride(c: int) -> int:
    """Floats of a row of a block's partials: dgamma's C columns and
    dbeta's, rounded up to 4."""
    return _pad4(c + 1)


def _c8(c: int) -> int:
    return -(-c // 8) * 8


def bwd_mma_stride(c: int) -> int:
    """The tensor-core path's row stride of gamma, x^2 and u, in (hi, lo)
    pairs (csrc/gdn_backward.cu:mma_stride): every column a product reads
    (C rounded up to 8, P3's m16 tiles over C and n8 tiles over C + 1),
    4 mod 8, so that a fragment's half-warp reads distinct bank pairs."""
    return max(16 * -(-c // 16), 8 * -(-(c + 1) // 8)) + 4


def bwd_mma_fstride(c: int) -> int:
    """The tensor-core path's row stride of x and g, in floats: C rounded
    up to 8, 8 mod 16."""
    return _c8(c) if _c8(c) % 16 else _c8(c) + 8


def bwd_mma_p3_nt(threads: int) -> int:
    """n8 tiles of the tensor-core path's P3 warp tiles (one m16 tile of o
    by them): 4 in a block of 256 threads, 8 in one of 512 (csrc:
    mma_p3_nt)."""
    return 8 if threads == 512 else 4


def bwd_mma_p3_fits(c: int, threads: int) -> bool:
    """Whether P3's warp tiles, one a warp, fit the block's warps (csrc:
    mma_p3_fits): C <= 63 at 256 threads, C <= 127 at 512."""
    n3 = -(-(c + 1) // 8)
    return -(-c // 16) * -(-n3 // bwd_mma_p3_nt(threads)) <= threads // 32


def gdn_backward_smem_bytes(c: int, tile_rows: int, smem_gamma: bool,
                            mma: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/gdn_backward.cu:
    smem_bytes): gamma if staged, four float32 tiles (x^2, u, x, g) and
    beta, all at `bwd_row_stride`; on the tensor cores (mma_smem_bytes)
    gamma's C8 rows, the x^2 and u tiles as (hi, lo) pairs at
    `bwd_mma_stride`, x and g as floats at `bwd_mma_fstride`, beta. The
    same in float32 and bf16."""
    if mma:
        ls = bwd_mma_stride(c)
        return (8 * _c8(c) * ls + 16 * tile_rows * ls
                + 8 * tile_rows * bwd_mma_fstride(c) + 4 * _c8(c))
    ls = bwd_row_stride(c)
    return 4 * ((bwd_gamma_rows(c) * ls if smem_gamma else 0)
                + 4 * tile_rows * ls + bwd_gamma_rows(c))


def bwd_resident_per_sm(c: int, tile_rows: int, smem_gamma: bool,
                        threads: int = 256, mma: bool = False) -> int:
    """Blocks one SM holds at once, by registers (128 a thread) and shared
    memory."""
    return min(_BWD_REG_BLOCKS * 256 // threads, _SM_SMEM // (
        gdn_backward_smem_bytes(c, tile_rows, smem_gamma, mma) + 1024))


def bwd_p3_tiles(c: int) -> int:
    """P3's 32 x 32 warp tiles over the C x (C + 1) partials."""
    return -(-c // BWD_P3) * -(-(c + 1) // BWD_P3)


def bwd_partial_floats(c: int, blocks: int) -> int:
    """The partials buffer: a slice a block."""
    return blocks * c * bwd_partial_stride(c)


def _split_fits(c: int, tile_rows: int, threads: int = 256) -> bool:
    """P3's kept sums fit: at most a warp tile a warp, whose 1024 floats
    each the block adds up through its tile buffers."""
    return (bwd_p3_tiles(c) <= threads // 32 and bwd_p3_tiles(c) * 1024
            <= 4 * tile_rows * bwd_row_stride(c))


def bwd_gamma_pad_floats(c: int) -> int:
    return bwd_gamma_rows(c) * bwd_row_stride(c) + _BWD_SLACK


def _mma_plan(n: int, c: int):
    """The tensor-core plan for (n, c), or None where it has none: 256
    threads, two blocks an SM, where P3's warp tiles fit 8 warps (C <=
    63), else 512 threads, one block (C <= 127); the smallest tile of
    BWD_MMA_TILES that leaves each resident block at most one tile, else
    64 rows where that many blocks fit an SM (C <= 48 at 256 threads),
    else 32, else 16 (C >= 121); persistent blocks as
    `gdn_backward_plan`'s. (The best of the tiles and thread counts that
    a scratch sweep timed at C = 42, 50 and 100 on an H100; chip_smoke's
    phase 3 times the plan beside the CUDA-core path at every train
    shape, PERF.md.)"""
    cap = BWD_PARTIAL_MAX_BYTES // (4 * c * bwd_partial_stride(c))
    for threads, per_sm in ((256, 2), (512, 1)):
        if not bwd_mma_p3_fits(c, threads):
            continue
        fits = [t for t in BWD_MMA_TILES
                if gdn_backward_smem_bytes(c, t, True, True) <= MAX_SMEM
                and bwd_resident_per_sm(c, t, True, threads, True) >= per_sm]
        if not fits:
            return None
        one = [t for t in fits if -(-n // t) <= SMS * per_sm]
        tr = (one[0] if one else 64 if 64 in fits else 32 if 32 in fits
              else fits[-1])
        blocks = max(1, min(-(-n // tr), SMS * per_sm, cap))
        return GDNBackwardPlan(2, tr, blocks, True, 0, threads, True)
    return None


def _cuda_core_plan(n: int, c: int) -> GDNBackwardPlan:
    cap = BWD_PARTIAL_MAX_BYTES // (4 * c * bwd_partial_stride(c))
    if (8 < bwd_p3_tiles(c) <= 16 and n > BWD_WIDE_ROWS
            and _split_fits(c, 64, 512)
            and gdn_backward_smem_bytes(c, 64, True) <= MAX_SMEM):
        return GDNBackwardPlan(2, 64, max(1, min(-(-n // 64), SMS, cap)),
                               True, 16 // bwd_p3_tiles(c), 512)
    wcols = -(-c // WARP_COLS)
    for smem_gamma in (True, False):
        for per_sm in (_BWD_REG_BLOCKS, 1):
            tr = 256
            while tr > 16 and tr // 2 >= n:
                tr //= 2
            while tr >= 16 and bwd_resident_per_sm(c, tr, smem_gamma) < per_sm:
                tr //= 2
            if tr < 16 or (gdn_backward_smem_bytes(c, tr, smem_gamma)
                           > MAX_SMEM):
                continue
            rm = 2 if tr < 32 or tr // 16 * wcols <= 8 else 4
            split = (8 // bwd_p3_tiles(c) if rm == 2 and smem_gamma
                     and _split_fits(c, tr) else 0)
            tiles = -(-n // tr)
            blocks = max(1, min(tiles, SMS * per_sm, cap))
            return GDNBackwardPlan(rm, tr, blocks, smem_gamma, split)
    raise ValueError(f"gdn backward: no plan fits C={c} in a block's "
                     "shared memory")


def bwd_takes_mma(n: int, c: int) -> bool:
    """Whether `gdn_backward_plan` gives (n, c) the tensor cores: where they
    have a plan (C <= 127) and C is at least BWD_MMA_MIN_CHANNELS or the
    rows at most BWD_MMA_NARROW_ROWS."""
    return ((c >= BWD_MMA_MIN_CHANNELS or n <= BWD_MMA_NARROW_ROWS)
            and _mma_plan(n, c) is not None)


@functools.lru_cache(maxsize=512)
def gdn_backward_plan(n: int, c: int, mma: bool = None) -> GDNBackwardPlan:
    """The backward's launch for (n, c) rows; `mma` True or False asks for
    the tensor-core or the CUDA-core path's plan (raising where the
    tensor cores have none), None takes the tensor cores where
    `bwd_takes_mma` (the shapes where they were faster in chip_smoke's
    phase 3 on an H100, PERF.md), else the CUDA cores.

    The tensor cores' plan is `_mma_plan`'s. The CUDA cores': gamma in
    shared memory where it fits beside the tiles; the largest power-of-two
    tile of 16-256 rows (no more than n needs) at which two blocks share an
    SM, else one; 2 rows a thread where the tile is 16 rows or that leaves
    P1 at most 8 warp tiles (one a warp), else 4; P3's sums kept in
    registers (`split` warps a warp tile, all 8 warps busy) where its warp
    tiles allow (C <= 63). For C 64-127 (9-16 of P3's warp tiles) and more
    than 8192 rows, one block of 512 threads an SM, 64-row tiles and P3's
    sums kept, a warp a warp tile, where gamma fits in shared memory
    (below 8192 rows the 256-thread blocks were faster). Persistent blocks,
    at most as many as are resident on the SMs, as there are tiles, and as
    keep the partials within BWD_PARTIAL_MAX_BYTES. Raises where no plan
    fits. (Chosen from A/B runs and sweeps of plans at the rgb train
    step's shapes on an H100: two blocks an SM beat one at every C swept
    with P3's partials added each tile; see PERF.md.)"""
    if mma is None:
        mma = bwd_takes_mma(n, c)
    if not mma:
        return _cuda_core_plan(n, c)
    plan = _mma_plan(n, c)
    if plan is None:
        raise ValueError(f"gdn backward: the tensor cores have no plan at "
                         f"C={c}")
    return plan


@functools.lru_cache(maxsize=256)
def check_backward_plan(n: int, c: int, plan: GDNBackwardPlan) -> None:
    """Raise ValueError for a plan csrc/gdn_backward.cu has no kernel for
    at (n, c): no blocks or more than tiles, too much shared memory,
    threads other than 256 or 512, flags that are not bools. On the CUDA
    cores: rows per thread other than 2 or 4, tiles off the warps' 8 x rm
    rows, a split of P3 past the block's warps, or one with 4 rows a
    thread, gamma in global memory, more warps than the block has or sums
    its tile buffers do not hold; 512 threads without a split. On the
    tensor cores: rm other than 2, gamma not in shared memory, a split,
    tiles off 16 rows, P3's warp tiles past the block's warps."""
    rm, tr, blocks, smem_gamma, split, nthreads, mma = plan
    warps = nthreads // 32
    if (not isinstance(mma, bool) or not isinstance(smem_gamma, bool)
            or blocks < 1 or nthreads not in BWD_THREADS):
        bad = True
    elif mma:
        bad = (rm != 2 or not smem_gamma or split != 0 or tr < 16
               or tr % 16 or blocks > -(-n // tr)
               or not bwd_mma_p3_fits(c, nthreads)
               or gdn_backward_smem_bytes(c, tr, True, True) > MAX_SMEM)
    else:
        bad = (rm not in BWD_RMS or tr < 8 * rm or tr % (8 * rm)
               or blocks > -(-n // tr)
               or gdn_backward_smem_bytes(c, tr, smem_gamma) > MAX_SMEM
               or not 0 <= split <= warps
               or (nthreads != 256 and not split)
               or (split and (rm != 2 or not smem_gamma
                              or not _split_fits(c, tr, nthreads)
                              or bwd_p3_tiles(c) * split > warps)))
    if bad:
        raise ValueError(f"gdn backward plan {tuple(plan)}: no kernel for "
                         f"it at N={n}, C={c}")


def backward_block_tiles(n: int, plan: GDNBackwardPlan):
    """[[(row0, rows), ...] of each block, in the order it walks them]:
    block b takes tiles b, b + blocks, ..."""
    tiles = -(-n // plan.tile_rows)
    return [[(t * plan.tile_rows, min(plan.tile_rows, n - t * plan.tile_rows))
             for t in range(b, tiles, plan.blocks)]
            for b in range(plan.blocks)]


def backward_partial_tiles(c: int):
    """[(o0, o1, j0, j1)]: the parts of a block's C x (C + 1) partials
    (dgamma's columns, then dbeta's) that P3's 32 x 32 warp tiles store,
    clipped to the partials' rows and padded columns."""
    ps = bwd_partial_stride(c)
    return [(o, min(o + 32, c), j, min(j + 32, ps))
            for o in range(0, c, 32) for j in range(0, c + 1, 32)]


def gdn_backward_plain(x2d, g, gamma, beta, inverse: bool):
    """The closed form of mmnc_tpu/ops/gdn_pallas.py:_bwd in torch, the
    kernel's plain version: (dx in x's type, dgamma, dbeta in float32).
    A bf16 x and g are computed with in float32."""
    dtype, x = x2d.dtype, x2d
    if dtype == torch.bfloat16:
        x, g = x.float(), g.float()
    x2 = x * x
    norm = x2 @ gamma.t() + beta
    if inverse:
        s = torch.sqrt(norm)
        u = g * x / s
        dx = g * s + x * (u @ gamma)
        dgamma = 0.5 * (u.t() @ x2)
        dbeta = 0.5 * u.sum(0)
    else:
        r = torch.rsqrt(norm)
        u = g * x * (r * r * r)
        dx = g * r - x * (u @ gamma)
        dgamma = -0.5 * (u.t() @ x2)
        dbeta = -0.5 * u.sum(0)
    return dx.to(dtype), dgamma, dbeta


@functools.cache
def _backward_entry():
    fn = _build.load("gdn_backward").mmnc_gdn_backward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gdn_backward_cuda(x2d, g, gamma, beta, inverse: bool,
                      plan: GDNBackwardPlan = None):
    """Launch csrc/gdn_backward.cu on CUDA tensors: x and g float32 or
    bfloat16 (both one type; g in any layout: a strided g is copied
    contiguous on the card), gamma and beta float32. Returns (dx in x's
    type, dgamma, dbeta in float32); raises on anything else.

    `plan` overrides `gdn_backward_plan` (tests, chip_smoke.py's sweeps).
    Scratch (the blocks' partials, gamma's padded copy) comes from
    `torch.empty` on the current stream, so under a CUDA graph capture
    (`train/step.py`) it comes from the graph's pool and the launches are
    nodes of the graph; `launches` counts a capture once and a replay
    never."""
    n, c = x2d.shape
    if x2d.dtype not in (torch.float32, torch.bfloat16) \
            or g.dtype != x2d.dtype or gamma.dtype != torch.float32 \
            or beta.dtype != torch.float32:
        raise ValueError("gdn_backward_cuda takes float32 or bfloat16 x and "
                         "g of one type and float32 gamma and beta, got "
                         f"{x2d.dtype}, {g.dtype}, {gamma.dtype}, "
                         f"{beta.dtype}")
    if g.shape != x2d.shape or gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"g {tuple(g.shape)} / gamma {tuple(gamma.shape)} "
                         f"/ beta {tuple(beta.shape)} do not match x "
                         f"{tuple(x2d.shape)}")
    if not (x2d.is_cuda and g.is_cuda and gamma.is_cuda and beta.is_cuda):
        raise ValueError("gdn_backward_cuda takes CUDA tensors")
    if n == 0:
        return (torch.empty_like(x2d), torch.zeros_like(gamma),
                torch.zeros_like(beta))
    plan = (GDNBackwardPlan(*plan) if plan is not None
            else gdn_backward_plan(n, c))
    check_backward_plan(n, c, plan)
    x2d, g = x2d.contiguous(), g.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    dx = torch.empty_like(x2d)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    partial = torch.empty(bwd_partial_floats(c, plan.blocks),
                          device=x2d.device)
    gamma_pad = (None if plan.smem_gamma else
                 torch.empty(bwd_gamma_pad_floats(c), device=x2d.device))
    rc = _backward_entry()(
        x2d.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if gamma_pad is None else gamma_pad.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, c,
        plan.rm, plan.tile_rows, plan.blocks, int(plan.smem_gamma),
        plan.split, plan.threads, int(plan.mma), int(inverse),
        int(x2d.dtype == torch.bfloat16),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check_launch(rc, "gdn backward")
    gdn_backward_cuda.launches += 1
    return dx, dgamma, dbeta


gdn_backward_cuda.launches = 0


def _widest_backward() -> int:
    return max(c for c in range(1, 2048)
               if gdn_backward_smem_bytes(c, 16, False) <= MAX_SMEM)


# The widest C the backward's smallest plan (16 rows, 2 a thread, gamma in
# global memory) fits; above the forward's MAX_CHANNELS, so every C the
# forward launches at has a backward.
BWD_MAX_CHANNELS = _widest_backward()


class GDNFunction(torch.autograd.Function):
    """(N, C) x (C, C) x (C,) -> (N, C), closed-form backward."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, inverse):
        ctx.save_for_backward(x2d, gamma, beta)
        ctx.inverse = inverse
        return gdn_rows(x2d, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        """g may be strided (any layout the next layer's backward gives).
        dx comes back in x's type, dgamma and dbeta in the parameters'
        float32: the plain version on the CPU, else the kernel."""
        x, gamma, beta = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = gdn_backward_plain(x, g, gamma, beta, ctx.inverse)
        else:
            grads = gdn_backward_cuda(x, g, gamma, beta, ctx.inverse)
        return (*grads, None)


def gdn(x, gamma, beta, inverse: bool = False):
    """Channels-last wrapper: x (..., C), gamma (C, C) [out, in], beta (C,)."""
    c = x.shape[-1]
    y = GDNFunction.apply(x.contiguous().view(-1, c), gamma, beta, inverse)
    return y.view(x.shape)
