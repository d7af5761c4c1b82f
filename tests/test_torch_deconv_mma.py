"""deconv+IGDN's bf16 tiled stages on the tensor cores ("tiled_mma",
csrc/deconv_igdn.cu:deconv_igdn_mma_kernel) on the CPU, where there is no
card to run them:

* the launch plan: with float32 (the default) it is the plan of the
  kernels that were there before, and it never takes the tensor cores;
  with bf16 it takes them at the five stages where cuDNN's bf16
  transposed conv beat the CUDA-core kernel and at the bench's, and never
  for Cout <= 4 or the split and L2 shapes;
* every tensor-core plan fits a block's shared memory and its grid writes
  each output value once;
* the kernel emulated block by block in numpy float64 (`_emulate_mma`):
  the plan, the weight stages as each thread stages its items, the input
  tile by its 16-byte chunks of halo rows (over-reads past x NaN), the
  bf16 tile and stages with NaN in every word not written, the zeroed K
  and N pads, the m16n8k16 fragment maps of A (ldmatrix.x4), B
  (ldmatrix.x4.trans, .x2.trans) and C per lane, the fixed order of K
  (chunks, taps in kernel-index order, k16 steps) and the epilogue with
  its skewed y^2.
  Its sums equal the float64 transposed conv within 1e-10 (the products
  of bf16 values are exact; float64 sums of up to 9 x 100 of them err
  below 2^-40 of their size);
* the emulation followed by the bf16 roundings (the sum, then + the bias)
  and the epilogue, against mmnc_tpu's bf16 Deconv + GDN chain run on the
  CPU (as tests/test_torch_bf16.py runs it), under chip_smoke's
  rounding-boundary rule: the two sums round alike except where the
  float64 sum lies within float32 summation error of a bf16 boundary
  (twice (n - 1) u sum|terms|, n = 9 Cin), y is the rounded sum plus the
  bias, rounded, where they do, and the output lies within 2^-7 x max(1,
  |ref|max) of the chain's (the chain squares y in bf16 and rounds its
  norm, the kernel does neither: chip_smoke.BF16_TOL).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mmnc_tpu.ops import layers as jl

from mmnc_tpu_torch.ops import deconv_igdn as dm
from mmnc_tpu_torch.ops.deconv_igdn import (MAX_SMEM, MMA_MAX_WARPS, MMA_P,
                                            TILES, launch_plan,
                                            mma_smem_bytes, parity_taps,
                                            tile_shape, tiled_blocks,
                                            tiled_mma_config)

BF16 = torch.bfloat16
SKEW = 4  # csrc/deconv_igdn.cu:kMmaSkew
# the bf16 stages where the CUDA-core kernel lost to cuDNN (batch 8), and
# the bench's tiled bf16 stages (batch 64)
FIVE = [(8, 32, 32, 50, 50), (8, 16, 16, 100, 50), (8, 64, 64, 21, 17),
        (8, 128, 128, 17, 17), (8, 32, 32, 21, 21)]
BENCH = [(64, 16, 16, 100, 50), (64, 32, 32, 50, 50)]


def _cdiv(a, b):
    return -(-a // b)


def _shapes():
    """(B, H, W, Cin, Cout) of every launch chip_smoke.py checks (as
    tests/test_torch_ops.py lists them) and the bench's at batch 64."""
    shapes = set(chip_smoke.deconv_path_shapes(64))
    for b in (1, 2, 4, 8, 16):
        shapes |= set(chip_smoke.deconv_path_shapes(b))
        for name in ("shared4", "mixed", "disjoint"):
            shapes |= set(chip_smoke.mt_deconv_shapes(
                chip_smoke.paper_layout(*chip_smoke.PAPER[name]), b))
    shapes |= set(chip_smoke.split_extra_shapes()
                  + chip_smoke.wide_deconv_shapes())
    return sorted({s[:5] for s in shapes})


SHAPES = _shapes()


# --- (a) the launch plan -----------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_float32_plan_is_unchanged_and_bf16_differs_only_on_tensor_cores(
        shape):
    """The default dtype is float32's plan, which never takes the tensor
    cores; bf16's is the same plan except where it takes them, and only in
    place of the CUDA-core tiled kernel."""
    f32 = launch_plan(*shape)
    assert f32 == launch_plan(*shape, dtype=torch.float32)
    assert f32[0] in ("tiled", "tiled_l2", "split")
    if f32[0] == "tiled":
        assert f32 == ("tiled", *tile_shape(*shape), 1)
    bf = launch_plan(*shape, dtype=BF16)
    if bf[0] == "tiled_mma":
        assert f32[0] == "tiled" and shape[4] > 4
        assert tiled_mma_config(*shape[1:], *bf[1:3]) is not None
    else:
        assert bf == f32


@pytest.mark.parametrize("shape", FIVE + BENCH, ids=str)
def test_bf16_plan_takes_the_tensor_cores_where_cudnn_won(shape):
    assert launch_plan(*shape, dtype=BF16)[0] == "tiled_mma"


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[4] <= 4
                                   or launch_plan(*s)[0] != "tiled"],
                         ids=str)
def test_bf16_plan_keeps_narrow_cout_split_and_l2_shapes(shape):
    """Cout <= 4 (four-plane blocks), the latent stages (split) and Cout
    above the tiled kernel's reach (tiled_l2) keep their kernels."""
    assert launch_plan(*shape, dtype=BF16) == launch_plan(*shape)


# --- (b) fit and grid --------------------------------------------------------

def _mma_writes(b, h, w, cout, ta, tb):
    """How many times a tensor-core launch stores each (output pixel,
    channel) of one image: grid (4 x tiles, B), block x = 4 tile + parity;
    the epilogue's items (group of MMA_P positions along a tile row,
    channel quad) store a position inside the image, channels below Cout
    (csrc/deconv_igdn.cu:plane_epilogue)."""
    count = np.zeros((2 * h, 2 * w, cout), np.int64)
    tiles_w, cq = _cdiv(w, tb), _cdiv(cout, 4)
    bx = np.arange(4 * _cdiv(h, ta) * tiles_w)[:, None, None, None]
    tile, q = bx >> 2, bx & 3
    a0, b0 = tile // tiles_w * ta, tile % tiles_w * tb
    e = np.arange(ta * tb // MMA_P * cq)[None, :, None, None]
    eg, o = e // cq, 4 * (e % cq)
    i = np.arange(MMA_P)[None, None, :, None]
    j = np.arange(4)[None, None, None, :]
    ia, ib, ch = np.broadcast_arrays(a0 + eg * MMA_P // tb,
                                     b0 + eg * MMA_P % tb + i, o + j)
    qq = np.broadcast_to(q, ia.shape)
    keep = (ia < h) & (ib < w) & (ch < cout)
    np.add.at(count, (2 * ia[keep] + (qq[keep] >> 1),
                      2 * ib[keep] + (qq[keep] & 1), ch[keep]), 1)
    return count


_MMA_CASES = sorted(
    {(s, launch_plan(*s, dtype=BF16)[1:3]) for s in SHAPES + FIVE + BENCH
     if launch_plan(*s, dtype=BF16)[0] == "tiled_mma"}
    | {((2, 16, 16, 42, 21), t) for t in TILES
       if tiled_mma_config(16, 16, 42, 21, *t)}
    | {((1, 13, 9, 17, 21), (8, 8)), ((1, 9, 16, 50, 17), (4, 8))}, key=str)


@pytest.mark.parametrize("shape,tile", _MMA_CASES, ids=str)
def test_mma_plan_fits_and_its_grid_writes_each_output_once(shape, tile):
    """Shared memory within the H100's dynamic limit (and as counted by
    `mma_smem_bytes`), whole warps, one m16 tile a warp, N covered, and
    each (output pixel, channel) stored once."""
    b, h, w, cin, cout = shape
    c = tiled_mma_config(h, w, cin, cout, *tile)
    assert c.smem_bytes <= MAX_SMEM
    assert c.smem_bytes == mma_smem_bytes(*tile, cin, cout, 8 * c.nt * c.ng,
                                          c.nv, c.chunk)
    assert c.threads == 32 * _cdiv(tile[0] * tile[1], 16) * c.ng
    assert c.threads <= 32 * MMA_MAX_WARPS
    assert 8 * c.nt * c.ng >= cout and 8 * c.nt * (c.ng - 1) < cout
    assert c.chunk % 16 == 0 and (c.nb // 8) % 2 == 1 and (c.xs // 8) % 2 == 1
    assert c.nb >= 8 * c.nt * c.ng
    assert c.items in (1, dm.MMA_ITEMS)
    assert c.chunk * 4 * c.nt * c.ng <= c.items * c.threads
    assert tiled_blocks(b, h, w, *tile, cout) == b * 4 * _cdiv(
        h, tile[0]) * _cdiv(w, tile[1])
    assert (_mma_writes(1, h, w, cout, *tile) == 1).all()


def test_mma_config_refuses_what_the_kernel_has_no_block_for():
    assert tiled_mma_config(8, 12, 50, 50, 4, 4) is None   # tb not 8k
    assert tiled_mma_config(16, 16, 50, 3, 8, 8) is None   # Cout <= 4
    assert tiled_mma_config(32, 64, 21, 21, 16, 32) is None  # 32 warps


# --- (c) the kernel emulated block by block ---------------------------------

def _bf16(a):
    """float32 values rounded to bf16 (nearest even), in float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).double(
    ).numpy()


def _emulate_mma(x, w, bias, gamma, beta, mode, ta, tb):
    """csrc/deconv_igdn.cu's tensor-core kernel run block by block on numpy
    arrays in float64, x and w holding bf16 values, x's data 16-byte
    aligned. Returns (sums, y, out, stores): the MMAs' sums of each output
    value, y as the kernel makes it (the float32 sum rounded to bf16, +
    the bias, rounded), the epilogue's output before its rounding at the
    store, and the stores of each output value."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    c = tiled_mma_config(h, wd, cin, cout, ta, tb)
    knt, ng, chunk, nv, nb, xs = c.nt, c.ng, c.chunk, c.nv, c.nb, c.xs
    cp, npos, wx = 4 * _cdiv(cout, 4), ta * tb, tb + 2
    hw, kx, np_ = (ta + 2) * wx, xs - 8, 8 * knt * ng
    nchunks = _cdiv(cin, chunk)
    stage_elems = nv * chunk * nb
    stage_bytes = 2 * (2 if nchunks > 1 else 1) * stage_elems
    y_bytes = 4 * (2 * npos * cp + npos // MMA_P * SKEW)
    assert c.smem_bytes == (max(stage_bytes, y_bytes) + 2 * hw * xs
                            + 4 * (cout * cp + cp))
    threads, warps, pairs = c.threads, c.threads // 32, np_ // 2
    assert chunk * pairs <= c.items * threads
    # x flat, NaN past its ends: what a 16-byte chunk over-reads
    x_flat = np.concatenate([np.full(8, np.nan), x.reshape(-1),
                             np.full(8, np.nan)])
    wf = w.reshape(-1)
    shape = (bsz, 2 * h, 2 * wd, cout)
    sums, y_out, out = (np.full(shape, np.nan) for _ in range(3))
    stores = np.zeros(shape, np.int64)
    tiles_w = _cdiv(wd, tb)
    lanes = np.arange(32)
    g, t4 = lanes >> 2, lanes & 3
    for n in range(bsz):
        for bx in range(4 * _cdiv(h, ta) * tiles_w):
            tile, q = bx >> 2, bx & 3
            dh, dw = q >> 1, q & 1
            a0, b0 = tile // tiles_w * ta, tile % tiles_w * tb
            t_lo, nt = parity_taps(dh, a0, ta, h)
            s_lo, ns = parity_taps(dw, b0, tb, wd)
            ntaps = nt * ns
            assert ntaps <= nv
            tap = [((2 * (t_lo + sl // ns) + dh) * 5 + 2 * (s_lo + sl % ns)
                    + dw) * cin * cout for sl in range(ntaps)]
            w_s = np.full((2, nv, chunk, nb), np.nan)  # the bf16 stages
            x_s = np.full(hw * xs, np.nan)
            for i in range(hw * xs // 8):  # zeroed, 8 values a store
                x_s[8 * i:8 * i + 8] = 0.0

            def stage(k):  # load_chunk, then store_chunk, thread by thread
                c0 = k * chunk
                for tid in range(threads):
                    for it in range(c.items):
                        r, o2 = divmod(tid + it * threads, pairs)
                        o = 2 * o2
                        live = r < chunk and c0 + r < cin and o < cout
                        for slot in range(ntaps):
                            v = [0.0, 0.0]
                            if live:
                                at = tap[slot] + (c0 + r) * cout + o
                                v[0] = wf[at]
                                if o + 1 < cout:
                                    v[1] = wf[at + 1]
                            if r < chunk:
                                w_s[k & 1, slot, r, o:o + 2] = _bf16(v)

            stage(0)
            g_s = np.full(cout * cp, np.nan)
            for i in range(cout * cout):
                o, j = divmod(i, cout)
                g_s[j * cp + o] = gamma.reshape(-1)[i]
            b_s = np.full(cp, np.nan)
            b_s[:cout] = beta
            # the input tile: (halo row, 16-byte chunk) items, 4 a thread
            ib_lo, ib_hi = max(b0 - 1, 0), min(b0 + tb + 1, wd)
            row_elems = (ib_hi - ib_lo) * cin
            col_lo = ib_lo - (b0 - 1)
            row_chunks = row_elems // 8 + 2
            for i in range((ta + 2) * row_chunks):
                r, j = divmod(i, row_chunks)
                ia = a0 - 1 + r
                if not 0 <= ia < h:
                    continue
                start = ((n * h + ia) * wd + ib_lo) * cin  # in values
                at = (2 * start) // 16 * 8 + 8 * j         # 16-byte aligned
                if at >= start + row_elems:
                    continue
                v = x_flat[8 + at:8 + at + 8]
                off = at - start
                e0 = max(off, 0)
                pix, ch = divmod(e0, cin)
                for k in range(8):
                    if e0 <= off + k < row_elems:
                        x_s[((r * wx + col_lo) + pix) * xs + ch] = v[k]
                        ch += 1
                        if ch == cin:
                            ch, pix = 0, pix + 1
            acc = np.zeros((warps, 16, 8 * knt))  # D of each warp
            for k in range(nchunks):
                if k + 1 < nchunks:
                    stage(k + 1)  # its stage was last read in chunk k - 1
                c0 = k * chunk
                steps = min(kx - c0, chunk) // 16
                stage_k = w_s[k & 1].reshape(-1)
                for warp in range(warps):
                    mi, ni = divmod(warp, ng)
                    p = np.minimum(16 * mi + (lanes & 15), npos - 1)
                    a_lane = ((p // tb + t_lo + dh) * wx + p % tb + s_lo
                              + dw) * xs + (lanes >> 4) * 8
                    b_lane = (((lanes & 7) + 8 * ((lanes >> 3) & 1)) * nb
                              + 8 * knt * ni + 8 * (lanes >> 4))
                    for ti in range(nt):
                        for si in range(ns):
                            for kk in range(steps):
                                addr = a_lane + (ti * wx + si) * xs + c0 \
                                    + kk * 16
                                a = np.full((16, 16), np.nan)
                                seen = np.zeros((16, 16), np.int64)
                                for m in range(4):  # ldmatrix.x4 matrix m
                                    rows = addr[8 * m + g]  # lane 8m + L / 4
                                    for e in range(2):
                                        rr = g + 8 * (m & 1)
                                        cc = 2 * t4 + 8 * (m >> 1) + e
                                        a[rr, cc] = x_s[rows + 2 * t4 + e]
                                        np.add.at(seen, (rr, cc), 1)
                                assert (seen == 1).all()
                                b_at = b_lane + ((ti * ns + si) * chunk
                                                 + kk * 16) * nb
                                b = np.full((16, 8 * knt), np.nan)
                                seen = np.zeros(b.shape, np.int64)
                                for j in range(0, knt, 2):  # .x4.trans, .x2
                                    for m in range(4 if j + 1 < knt else 2):
                                        # lane L: rows 2t, 2t + 1 of column
                                        # g of the matrix whose rows lanes
                                        # 8m.. 8m + 7 address
                                        for e in range(2):
                                            rows = b_at[8 * m + 2 * t4 + e]
                                            col = 8 * (j + (m >> 1)) + g
                                            rr = 8 * (m & 1) + 2 * t4 + e
                                            b[rr, col] = stage_k[rows + 8 * j
                                                                 + g]
                                            np.add.at(seen, (rr, col), 1)
                                assert (seen == 1).all()
                                acc[warp] += a @ b
            smem = np.full(max(stage_bytes, y_bytes) // 4, np.nan)  # y, y^2
            for warp in range(warps):
                mi, ni = divmod(warp, ng)
                for jj in range(knt):
                    for i in range(4):  # C fragment: (rows g, g+8) x (2t, 2t+1)
                        pos = 16 * mi + g + 8 * (i >> 1)
                        o = 8 * (knt * ni + jj) + 2 * t4 + (i & 1)
                        s = acc[warp, pos % 16, 8 * jj + 2 * t4 + (i & 1)]
                        for lane in range(32):
                            if pos[lane] >= npos or o[lane] >= cp:
                                continue
                            bv = bias[o[lane]] if o[lane] < cout else 0.0
                            v = _bf16(_bf16(np.float32(s[lane])) + bv)
                            at = pos[lane] * cp + o[lane]
                            smem[at] = v
                            smem[npos * cp + at + pos[lane] // MMA_P * SKEW] \
                                = v * v
                            pa, pb = divmod(int(pos[lane]), tb)
                            ia, ib = a0 + pa, b0 + pb
                            if ia < h and ib < wd and o[lane] < cout:
                                sums[n, 2 * ia + dh, 2 * ib + dw,
                                     o[lane]] = s[lane]
            cq = cp // 4
            for e in range(npos // MMA_P * cq):  # plane_epilogue
                eg, o = e // cq, 4 * (e % cq)
                row, col0 = eg * MMA_P // tb, eg * MMA_P % tb
                at = (row * tb + col0) * cp
                y2g = npos * cp + at + eg * SKEW
                for i in range(MMA_P):
                    ia, ib = a0 + row, b0 + col0 + i
                    if ia >= h or ib >= wd:
                        continue
                    for j in range(min(4, cout - o)):
                        v = smem[at + i * cp + o + j]
                        y_out[n, 2 * ia + dh, 2 * ib + dw, o + j] = v
                        if mode:
                            norm = b_s[o + j] + sum(
                                g_s[jj * cp + o + j] * smem[y2g + i * cp + jj]
                                for jj in range(cout))
                            v = (v * np.sqrt(norm) if mode == "igdn"
                                 else v / np.sqrt(norm))
                        out[n, 2 * ia + dh, 2 * ib + dw, o + j] = v
                        stores[n, 2 * ia + dh, 2 * ib + dw, o + j] += 1
    return sums, y_out, out, stores


def _case(shape, cout, seed):
    """bf16 values in float32: x ~ N(0, 1), the weight at the layers' init
    scale, bias 0.1 N(0, 1), gamma 0.1 I + 0.01 U(0, 1) (chip_smoke's
    deconv cases); beta 1 + 0.1 U(0, 1) in float32."""
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = _bf16(rng.normal(size=shape))
    w = _bf16((rng.random((5, 5, cin, cout)) * 2 - 1) / np.sqrt(25 * cin))
    b = _bf16(0.1 * rng.normal(size=(cout,)))
    gamma = _bf16(0.1 * np.eye(cout) + 0.01 * rng.random((cout, cout)))
    beta = (1.0 + 0.1 * rng.random((cout,))).astype(np.float32)
    return x, w, b, gamma, beta.astype(np.float64)


def _deconv64(x, w):
    """The transposed conv in float64 (exact sums of exact products, up to
    float64's own rounding), NHWC; and the same of |x| and |w|."""
    geometry = {"stride": 2, "padding": 2, "output_padding": 1}
    out = []
    for a, b in ((x, w), (np.abs(x), np.abs(w))):
        weight = torch.from_numpy(b).permute(2, 3, 0, 1).flip(2, 3)
        out.append(torch.nn.functional.conv_transpose2d(
            torch.from_numpy(a).permute(0, 3, 1, 2), weight, **geometry
        ).permute(0, 2, 3, 1).numpy())
    return out


# (B, H, W, Cin), Cout, tile: Cin 17 and 21 by plain loads, 50 by 4-byte,
# 100 by 8-byte and 32 by 16-byte copies; 1 to 7 chunks (the last with
# zeroed K rows from the third); 1 to 7 n8 tiles a warp in 1 to 3 groups;
# tiles cut by the image's edge
_EMULATED = [((1, 13, 9, 17), 21, (8, 8)), ((1, 9, 16, 50), 17, (4, 8)),
             ((1, 8, 16, 50), 50, (8, 16)), ((1, 8, 8, 100), 50, (8, 8)),
             ((2, 3, 16, 32), 21, (2, 8)), ((1, 5, 24, 21), 17, (4, 8))]


@pytest.mark.parametrize("shape,cout,tile", _EMULATED, ids=str)
def test_mma_kernel_as_emulated_sums_the_float64_deconv(shape, cout, tile):
    x, w, b, gamma, beta = _case(shape, cout, 0)
    sums, _, _, stores = _emulate_mma(x, w, b, gamma, beta, "igdn", *tile)
    assert (stores == 1).all()
    want, _ = _deconv64(x, w)
    np.testing.assert_allclose(sums, want, rtol=0, atol=1e-10)


def _apart_reach(v, exact, size):
    """The largest excess, in u sum|terms| (u = 2^-24), of |v - exact| over
    half v's bf16 gap towards `exact`, over the values v (bf16, in
    float64): chip_smoke.check_deconv_bf16's reach."""
    vt = torch.from_numpy(v.astype(np.float32)).to(BF16)
    towards = torch.where(torch.from_numpy(exact) > vt.double(),
                          float("inf"), float("-inf")).to(BF16)
    gap = (torch.nextafter(vt, towards).double() - vt.double()).abs().numpy()
    return float(((np.abs(v - exact) - gap / 2) / (2.0 ** -24 * size)).max())


@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
@pytest.mark.parametrize("shape,cout,tile", [_EMULATED[0], _EMULATED[2],
                                             _EMULATED[4]], ids=str)
def test_mma_emulation_rounded_matches_jax_bf16_chain(shape, cout, tile,
                                                      mode):
    x, w, b, gamma, beta = _case(shape, cout, 1)
    sums, y, out, _ = _emulate_mma(x, w, b, gamma, beta, mode, *tile)
    bf = jnp.bfloat16
    conv = np.asarray(jl.deconv(jnp.asarray(x, bf), jnp.asarray(w, bf)),
                      np.float64)
    y_ref = jnp.asarray(conv, bf) + jnp.asarray(b, bf)
    ref = y_ref
    if mode is not None:
        norm = jnp.einsum("bhwc,oc->bhwo", y_ref * y_ref,
                          jnp.asarray(gamma, bf),
                          preferred_element_type=jnp.float32) + beta
        scale = jnp.sqrt(norm) if mode == "igdn" else jax.lax.rsqrt(norm)
        ref = y_ref * scale.astype(bf)
    ref = np.asarray(ref, np.float64)
    rounded = _bf16(sums.astype(np.float32))
    apart = rounded != conv
    exact, size = _deconv64(x, w)
    if apart.any():
        for v in (rounded[apart], conv[apart]):
            assert _apart_reach(v, exact[apart], size[apart]) <= \
                2 * 9 * shape[-1]
    agree = ~apart
    assert np.array_equal(y[agree], np.asarray(y_ref, np.float64)[agree])
    assert np.array_equal(y, _bf16(_bf16(sums.astype(np.float32)) + b))
    tol = chip_smoke.BF16_TOL * max(1.0, np.abs(ref).max())
    assert np.abs(_bf16(out) - ref).max() <= tol
