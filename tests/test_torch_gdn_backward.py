"""The backward of (I)GDN (mmnc_tpu/ops/gdn_pallas.py:_bwd, the custom VJP
of gdn_pallas_2d) in mmnc_tpu_torch on the CPU: the plain version
`gdn_backward_plain` against JAX's VJP (the Pallas forward in interpret
mode), csrc/gdn_backward.cu's plan emulated in torch (row tiles on
persistent blocks, shared-memory layout, per-block partials and their
fixed-order sum) against JAX's `_bwd`, the plan's coverage and shared
memory, and the routing of `GDNFunction` on the CPU. The tensor-core path
(3xTF32 on mma.sync): TF32 rounding (cvt.rna) and the 3xTF32 product
emulated in numpy against float64, the kernel's padded (hi, lo) layout,
warp tiles and k steps emulated against the plain version and JAX, its
fragments' shared-memory banks, and which shapes the plan gives it.

Inputs come from a numpy seed and go to both packages as the same arrays.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mmnc_tpu.ops.gdn_pallas import _bwd, gdn_pallas_2d

from mmnc_tpu_torch.ops.gdn import (BWD_MAX_CHANNELS, BWD_MMA_MIN_CHANNELS,
                                   BWD_MMA_NARROW_ROWS,
                                   BWD_PARTIAL_MAX_BYTES, MAX_CHANNELS,
                                   MAX_SMEM, SMS, GDNBackwardPlan,
                                   GDNFunction, backward_block_tiles,
                                   backward_partial_tiles,
                                   bwd_gamma_pad_floats,
                                   bwd_gamma_rows, BWD_MMA_NT,
                                   bwd_mma_fstride, bwd_mma_p3_fits,
                                   bwd_mma_p3_nt, bwd_mma_stride,
                                   bwd_p3_tiles,
                                   bwd_partial_floats, bwd_partial_stride,
                                   bwd_resident_per_sm, bwd_row_stride,
                                   bwd_takes_mma,
                                   check_backward_plan, gdn_backward_cuda,
                                   gdn_backward_plain, gdn_backward_plan,
                                   gdn_backward_smem_bytes, gdn_cuda)


def _case(n, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    beta = (1 + 0.1 * rng.random(c)).astype(np.float32)
    return x, g, gamma, beta


def _jax_vjp(x, g, gamma, beta, inverse):
    """JAX's gradients through gdn_pallas_2d's custom VJP, its forward the
    Pallas kernel in interpret mode."""
    _, vjp = jax.vjp(lambda a, b, c: gdn_pallas_2d(a, b, c, inverse, True),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _jax_bwd(x, g, gamma, beta, inverse):
    return [np.asarray(v) for v in _bwd(
        inverse, False, (jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta)), jnp.asarray(g))]


def _assert_grads(got, want, rtol=1e-4, atol=1e-5):
    """Each gradient within rtol of JAX's and atol x max(1, |JAX's|max):
    dgamma and dbeta sum thousands of float32 terms, which JAX and torch
    add in other orders, so an entry that cancels to near 0 differs by
    the rounding of the terms' scale, not its own."""
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(b).max()))


# --- (a) the plain version against JAX --------------------------------------

@pytest.mark.parametrize("c", [1, 3, 10, 21, 50, 100, 168])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_backward_matches_jax_vjp(c, inverse):
    """Every C of the train path's (I)GDNs (rgb and shared4), at a ragged
    row count."""
    x, g, gamma, beta = _case(1031, c, seed=c)
    got = gdn_backward_plain(*map(torch.from_numpy, (x, g, gamma, beta)),
                             inverse)
    assert [t.dtype for t in got] == [torch.float32] * 3
    _assert_grads([t.numpy() for t in got],
                  _jax_vjp(x, g, gamma, beta, inverse))


@pytest.mark.parametrize("c", [3, 50, 100])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_backward_of_bf16_values_matches_jax_upcast(c, inverse):
    """bf16 x and g (the bf16 model's) computed with in float32: dgamma and
    dbeta as JAX's on the same values in float32, dx that rounded once to
    bf16."""
    x, g, gamma, beta = _case(1031, c, seed=100 + c)
    xb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
    gamma_b = torch.from_numpy(gamma).to(torch.bfloat16).float()
    dx, dgamma, dbeta = gdn_backward_plain(xb, gb, gamma_b,
                                           torch.from_numpy(beta), inverse)
    assert dx.dtype == torch.bfloat16
    assert dgamma.dtype == dbeta.dtype == torch.float32
    want = _jax_vjp(xb.float().numpy(), gb.float().numpy(), gamma_b.numpy(),
                    beta, inverse)
    _assert_grads([dgamma.numpy(), dbeta.numpy()], want[1:])
    _assert_grads([dx.float().numpy()], want[:1], rtol=2 ** -8)


# --- (b) the kernel's plan, emulated ----------------------------------------

def _cdiv(a, b):
    return -(-a // b)


def _emulate_backward(x, g, gamma, beta, inverse, plan):
    """csrc/gdn_backward.cu run block by block in torch float64: the plan's
    tiles on its blocks (`backward_block_tiles`), each block's flat shared
    memory (unwritten words NaN) at `bwd_row_stride` with the kernel's
    buffers in its order (gamma if staged, x^2, u, x, g, beta), gamma's
    padded global copy where it is not staged, the three products over
    their warp tiles' padded extents (a read past a row lands in the next
    row or buffer, as on the card), the partials (unwritten NaN), a slice a
    block: with split 0 written by its first tile and added to by the
    rest, else the sums of `split` row phases kept over the block's tiles,
    added up in phase order and written once; and their sum, block 0
    first. Returns (dx, dgamma, dbeta, stores per partial value)."""
    n, c = x.shape
    rm, tr, blocks, smem_gamma, split, _, _ = plan
    slices = max(split, 1)
    ls, grows, ps = (bwd_row_stride(c), bwd_gamma_rows(c),
                     bwd_partial_stride(c))
    c4 = _cdiv(c, 4) * 4
    f64 = torch.float64
    x, g, gamma, beta = (torch.as_tensor(a, dtype=f64)
                         for a in (x, g, gamma, beta))
    gpad = torch.zeros(grows, ls, dtype=f64)
    gpad[:c, :c] = gamma
    gpad = torch.cat([gpad.reshape(-1), torch.zeros(32, dtype=f64)])
    assert gpad.numel() == bwd_gamma_pad_floats(c)
    words = gdn_backward_smem_bytes(c, tr, smem_gamma) // 4
    x2_at = grows * ls if smem_gamma else 0
    u_at, xf_at = x2_at + tr * ls, x2_at + 2 * tr * ls
    gf_at, b_at = x2_at + 3 * tr * ls, x2_at + 4 * tr * ls
    assert b_at + grows == words
    partial = torch.full((blocks, c, ps), float("nan"), dtype=f64)
    stores = torch.zeros(blocks, c, ps, dtype=torch.int64)
    dx = torch.full((n, c), float("nan"), dtype=f64)
    rows_i = torch.arange(tr)

    def tile(at):
        return smem[at:at + tr * ls].view(tr, ls)

    def gather(base, buf, rows, cols):
        return buf[base + rows[:, None] * ls + cols[None, :]]

    on, jn3 = 32 * _cdiv(c, 32), 32 * _cdiv(c + 1, 32)
    for b, tiles in enumerate(backward_block_tiles(n, plan)):
        smem = torch.full((words,), float("nan"), dtype=f64)
        keep = torch.zeros(slices, on, jn3, dtype=f64)
        if smem_gamma:
            smem[:grows * ls] = gpad[:grows * ls]
            G = smem
        else:
            G = gpad
        smem[b_at:b_at + grows] = torch.cat([beta, torch.ones(grows - c,
                                                              dtype=f64)])
        for k, (row0, rows) in enumerate(tiles):
            # 1. x, g and x^2 of the real rows' first C columns; x^2's
            # columns past C (a 1 at C) set once a block, for every row
            if k == 0:
                tile(x2_at)[:, c:] = 0.0
                tile(x2_at)[:, c] = 1.0
            xs = x[row0:row0 + rows]
            tile(xf_at)[:rows, :c] = xs
            tile(gf_at)[:rows, :c] = g[row0:row0 + rows]
            tile(x2_at)[:rows, :c] = xs * xs
            # 2. P1 over every (r < tr, o < grows), then u and g r
            norm = (smem[b_at:b_at + grows]
                    + tile(x2_at)[:, :c4] @ gather(
                        0, G, torch.arange(grows), torch.arange(c4)).T)
            xv, gv = tile(xf_at)[:, :grows], tile(gf_at)[:, :grows]
            real = (rows_i < rows)[:, None] & (torch.arange(grows) < c)
            if inverse:
                s = torch.sqrt(norm)
                u, d = gv * xv / s, gv * s
            else:
                r = torch.rsqrt(norm)
                u, d = gv * xv * (r * r * r), gv * r
            tile(u_at)[:, :grows] = torch.where(real, u, 0.0)
            tile(gf_at)[:, :grows] = torch.where(real, d, gv)
            assert not tile(u_at)[:, :grows].isnan().any()
            # 3. P2 over (r < tr, j < 32 ceil(C / 32)): v = u @ gamma
            jn = 32 * _cdiv(c, 32)
            v = tile(u_at)[:, :c4] @ gather(0, G, torch.arange(c4),
                                            torch.arange(jn))
            xv, d = tile(xf_at)[:rows, :c], tile(gf_at)[:rows, :c]
            tile(xf_at)[:rows, :c] = (d + xv * v[:rows, :c] if inverse
                                      else d - xv * v[:rows, :c])
            # 4. P3 over the real rows (split: rows s, s + split, ... a
            # phase), (o, j') < 32 ceil(C / 32) x 32 ceil((C + 1) / 32)
            for ph in range(slices):
                rr = torch.arange(ph, rows, slices)
                acc = (gather(u_at, smem, rr, torch.arange(on)).T
                       @ gather(x2_at, smem, rr, torch.arange(jn3)))
                if split:
                    keep[ph] += acc
                    continue
                for o0, o1, j0, j1 in backward_partial_tiles(c):
                    part = acc[o0:o1, j0:j1]
                    if k:
                        part = partial[b, o0:o1, j0:j1] + part
                    partial[b, o0:o1, j0:j1] = part
                    stores[b, o0:o1, j0:j1] += 1
            # 5. dx
            dx[row0:row0 + rows] = tile(xf_at)[:rows, :c]
        if split:
            kept = keep[0]
            for ph in range(1, split):
                kept = kept + keep[ph]
            for o0, o1, j0, j1 in backward_partial_tiles(c):
                partial[b, o0:o1, j0:j1] = kept[o0:o1, j0:j1]
                stores[b, o0:o1, j0:j1] += 1
    total = torch.zeros(c, c + 1, dtype=f64)
    for b in range(blocks):
        total = total + partial[b, :, :c + 1]
    scale = 0.5 if inverse else -0.5
    return dx, scale * total[:, :c], scale * total[:, c], stores


def _tf32(a):
    """cvt.rna.tf32.f32 in numpy: each float32 to its nearest TF32 value
    (10 mantissa bits), ties away from zero: half the unit of the 13
    dropped bits added to the magnitude's bits (the sign is apart), then
    those 13 bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    """(hi, lo) of float32 values as the kernel's split_tf32: hi = tf32(a),
    lo = tf32(a - hi), a - hi exact in float32."""
    a = np.asarray(a, np.float32)
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _mma_product(ah, al, bh, bl, acc):
    """acc (m x n, float32) + A B in 3xTF32 from split operands (A m x K,
    B K x n, K a multiple of 8), k step by k step as the kernel's mma3:
    a_lo b_hi, a_hi b_lo, then a_hi b_hi, each an m16n8k8 whose exact
    products are summed and added to the float32 accumulator with one
    rounding."""
    acc = np.array(acc, np.float32)
    for k in range(0, ah.shape[1], 8):
        for a, b in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.astype(np.float64)
                   + a[:, k:k + 8].astype(np.float64)
                   @ b[k:k + 8].astype(np.float64)).astype(np.float32)
    return acc


def _product_3xtf32(a, b):
    """a @ b (float32) in 3xTF32 with float32 accumulation, K padded with
    zeros to a multiple of 8."""
    k8 = _cdiv(a.shape[1], 8) * 8
    a = np.pad(np.asarray(a, np.float32), ((0, 0), (0, k8 - a.shape[1])))
    b = np.pad(np.asarray(b, np.float32), ((0, k8 - b.shape[0]), (0, 0)))
    return _mma_product(*_split(a), *_split(b),
                        np.zeros((a.shape[0], b.shape[1]), np.float32))


def _sw(r, j, ls):
    """The (hi, lo) pair of element (r, j) at row stride ls."""
    return r * ls + j


def _mma_warp_tiles(tr, c):
    """P1's and P2's warp tiles in the kernel's order: [(first row, [the n8
    tiles whose sums it uses])]; each computes BWD_MMA_NT n8 tiles, the
    last repeated past C8."""
    n8 = _cdiv(c, 8)
    ngr = _cdiv(n8, BWD_MMA_NT)
    return [(wt // ngr * 16, [t for t in range(wt % ngr * BWD_MMA_NT,
                                               (wt % ngr + 1) * BWD_MMA_NT)
                              if t < n8])
            for wt in range(tr // 16 * ngr)]


def _mma_p3_tiles(c, threads):
    """P3's warp tiles of warps 0, 1, ...: [(first o, [the n8 tiles of j'
    it stores])]; each computes bwd_mma_p3_nt n8 tiles, the last repeated
    past 8 n3."""
    nt3, n3 = bwd_mma_p3_nt(threads), _cdiv(c + 1, 8)
    ng3 = _cdiv(n3, nt3)
    return [(w // ng3 * 16, [t for t in range(w % ng3 * nt3,
                                              (w % ng3 + 1) * nt3) if t < n3])
            for w in range(_cdiv(c, 16) * ng3)]


def _emulate_backward_mma(x, g, gamma, beta, inverse, plan):
    """csrc/gdn_backward.cu's tensor-core kernel run block by block in
    numpy: each block's flat shared memory (unwritten words NaN) with its
    buffers in the kernel's order (gamma, x^2 and u as (hi, lo) pairs at
    `bwd_mma_stride`, x and g as floats, beta); gamma split once, x^2's
    ones column and u's columns past C8 set once a block; per tile x^2
    rounded to float32 and split, P1 and P2 over the tile's rows x C8 and
    K = C8, P3 over K = the rows rounded up to 8 into sums kept over the
    block's tiles, all in 3xTF32 (`_mma_product`), the elementwise parts
    in float32; the block's slice stored by P3's warp tiles
    (`_mma_p3_tiles`, unwritten NaN), and their sum, block 0 first.
    Returns (dx, dgamma, dbeta, stores per partial value)."""
    n, c = x.shape
    tr, blocks = plan.tile_rows, plan.blocks
    ls, lf, c8 = bwd_mma_stride(c), bwd_mma_fstride(c), _cdiv(c, 8) * 8
    m3, n3, ps = _cdiv(c, 16), _cdiv(c + 1, 8), bwd_partial_stride(c)
    f32 = np.float32
    x, g, gamma, beta = (np.asarray(a, f32) for a in (x, g, gamma, beta))
    words = gdn_backward_smem_bytes(c, tr, True, True) // 4
    x2_at = 2 * c8 * ls
    u_at = x2_at + 2 * tr * ls
    xf_at = u_at + 2 * tr * ls
    gf_at = xf_at + tr * lf
    b_at = gf_at + tr * lf
    assert b_at + c8 == words
    partial = np.full((blocks, c, ps), np.nan, f32)
    stores = np.zeros((blocks, c, ps), np.int64)
    dx = np.full((n, c), np.nan, f32)
    every, k8 = np.arange(tr), np.arange(c8)

    def pairs(at, rows, cols):
        idx = at + 2 * _sw(rows[:, None], cols[None, :], ls)
        return smem[idx], smem[idx + 1]

    def put(at, rows, cols, v):
        idx = at + 2 * _sw(rows[:, None], cols[None, :], ls)
        smem[idx], smem[idx + 1] = _split(v)

    for b, tiles in enumerate(backward_block_tiles(n, plan)):
        smem = np.full(words, np.nan, f32)
        xf = smem[xf_at:gf_at].reshape(tr, lf)
        gf = smem[gf_at:b_at].reshape(tr, lf)
        gpad = np.zeros((c8, ls), f32)
        gpad[:c, :c] = gamma
        put(0, k8, np.arange(ls), gpad)
        smem[b_at:] = np.concatenate([beta, np.ones(c8 - c, f32)])
        ones = np.zeros((tr, ls), f32)
        ones[:, c] = 1.0
        put(x2_at, every, np.arange(ls), ones)
        put(u_at, every, np.arange(c8, ls), np.zeros((tr, ls - c8), f32))
        acc3 = np.zeros((16 * m3, 8 * n3), f32)
        for row0, rows in tiles:
            xs, gs = x[row0:row0 + rows], g[row0:row0 + rows]
            xf[:rows, :c], gf[:rows, :c] = xs, gs
            put(x2_at, np.arange(rows), np.arange(c), xs * xs)
            # P1 (B = gamma^T) and its epilogue
            ah, al = pairs(x2_at, every, k8)
            bh, bl = pairs(0, k8, k8)
            norm = _mma_product(ah, al, bh.T, bl.T,
                                np.broadcast_to(smem[b_at:], (tr, c8)))
            real = (every[:, None] < rows) & (k8[None, :] < c)
            xv, gv = xf[:, :c8], gf[:, :c8]
            with np.errstate(invalid="ignore"):
                if inverse:
                    s = np.sqrt(norm)
                    u, d = gv * xv / s, gv * s
                else:
                    r = f32(1) / np.sqrt(norm)
                    u, d = gv * xv * (r * r * r), gv * r
            u = np.where(real, u, f32(0))
            assert not np.isnan(u).any()
            gf[:, :c8] = np.where(real, d, gv)
            put(u_at, every, k8, u)
            # P2 (B = gamma) and dx in place of x
            ah, al = pairs(u_at, every, k8)
            bh, bl = pairs(0, k8, k8)
            v = _mma_product(ah, al, bh, bl, np.zeros((tr, c8), f32))
            xv, d = xf[:rows, :c], gf[:rows, :c]
            xf[:rows, :c] = (d + xv * v[:rows, :c] if inverse
                             else d - xv * v[:rows, :c])
            # P3 (A = u^T, B = x^2) over the rows rounded up to 8
            kr = np.arange(_cdiv(rows, 8) * 8)
            uh, ul = pairs(u_at, kr, np.arange(16 * m3))
            xh, xl = pairs(x2_at, kr, np.arange(8 * n3))
            acc3 = _mma_product(uh.T, ul.T, xh, xl, acc3)
            dx[row0:row0 + rows] = xf[:rows, :c]
        for m0, nts in _mma_p3_tiles(c, plan.threads):
            for q in nts:
                o = np.arange(m0, min(m0 + 16, c))
                j = np.arange(8 * q, min(8 * q + 8, ps))
                partial[b][np.ix_(o, j)] = acc3[np.ix_(o, j)]
                stores[b][np.ix_(o, j)] += 1
    total = np.zeros((c, c + 1))
    for b in range(blocks):
        total = total + partial[b, :, :c + 1]
    scale = 0.5 if inverse else -0.5
    return (torch.from_numpy(dx), torch.from_numpy(scale * total[:, :c]),
            torch.from_numpy(scale * total[:, c]), torch.from_numpy(stores))


# (n, c, plan): None for gdn_backward_plan's CUDA-core plan (mma=False),
# "plan" for its own choice (the tensor cores at every such entry), or a
# forced plan. The path's C at ragged row counts; blocks walking several
# tiles, 2 rows a thread, gamma read from its padded global copy, C = 655
# (the forward's widest); the tensor cores: 256 and 512 threads, tiles of
# 16-64 rows, a ragged last tile, the widest C they take (127), small C
# padded to the MMA's 8
_EMULATED = [
    (1031, 50, None), (1031, 100, None), (777, 168, None), (1000, 3, None),
    (300, 21, None), (37, 1, None),
    (1031, 100, GDNBackwardPlan(4, 64, 5, True)),
    (1031, 50, GDNBackwardPlan(2, 16, 7, True)),
    (1031, 50, GDNBackwardPlan(2, 64, 5, True, 1)),
    (1031, 21, GDNBackwardPlan(2, 32, 6, True, 3)),
    (1031, 100, GDNBackwardPlan(2, 64, 7, True, 1, 512)),
    (1031, 96, GDNBackwardPlan(2, 64, 5, True, 1, 512)),
    (999, 100, GDNBackwardPlan(4, 32, 3, False)),
    (333, 168, GDNBackwardPlan(2, 32, 4, False)),
    (200, MAX_CHANNELS, None),
    (1031, 42, None), (37, 100, None),
    (1031, 100, GDNBackwardPlan(2, 32, 9, True, 0, 512, True)),
    (1031, 50, GDNBackwardPlan(2, 64, 5, True, 0, 256, True)),
    (1031, 50, GDNBackwardPlan(2, 16, 7, True, 0, 512, True)),
    (777, 63, GDNBackwardPlan(2, 32, 5, True, 0, 256, True)),
    (333, 127, GDNBackwardPlan(2, 16, 6, True, 0, 512, True)),
    (300, 21, GDNBackwardPlan(2, 64, 2, True, 0, 256, True)),
    (37, 3, GDNBackwardPlan(2, 16, 2, True, 0, 256, True)),
    (1031, 50, "plan"), (1031, 100, "plan"), (1000, 3, "plan"),
    (300, 21, "plan"), (37, 1, "plan"), (1031, 42, "plan"),
    (37, 100, "plan")]


@pytest.mark.parametrize("n,c,plan", _EMULATED)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_plan_as_emulated_matches_jax_bwd(n, c, plan, inverse):
    """The kernel's indexing, emulated (`_emulate_backward`, or
    `_emulate_backward_mma` for the tensor cores), computes the plain
    version's gradients (no NaN from an unwritten word reaches one): in
    float64 within 1e-10 on the CUDA cores; in 3xTF32 with float32
    elementwise parts within chip_smoke's GDN_BACKWARD_TOL x max(1,
    |plain|max) on the tensor cores, the card's gate; JAX's `_bwd` within
    the plain version's tolerance; and stores every partial value a tile
    of its block (once a block where P3's sums are kept)."""
    x, g, gamma, beta = _case(n, c, seed=n + c)
    if plan is None:
        plan = gdn_backward_plan(n, c, mma=False)
        assert not plan.mma
    elif plan == "plan":
        plan = gdn_backward_plan(n, c)
        assert plan.mma
    check_backward_plan(n, c, plan)
    emulate = _emulate_backward_mma if plan.mma else _emulate_backward
    dx, dgamma, dbeta, stores = emulate(x, g, gamma, beta, inverse, plan)
    counts = [len(t) for t in backward_block_tiles(n, plan)]
    want_stores = (torch.ones(plan.blocks) if plan.split or plan.mma
                   else torch.tensor(counts))
    assert (stores == want_stores[:, None, None]).all()
    want = gdn_backward_plain(*(torch.from_numpy(a).double()
                                for a in (x, g, gamma, beta)), inverse)
    for got, w in zip((dx, dgamma, dbeta), want):
        if plan.mma:
            tol = chip_smoke.GDN_BACKWARD_TOL * max(1.0, w.abs().max())
            assert (got.double() - w).abs().max() <= tol
        else:
            torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)
    _assert_grads([dx.numpy(), dgamma.numpy(), dbeta.numpy()],
                  _jax_bwd(x, g, gamma, beta, inverse))


# --- (c) the plan ------------------------------------------------------------

def _train_path_shapes():
    """(rows, C) of every (I)GDN of the rgb train step at 16 and of
    shared4's at 16 and at 2 (chip_smoke's phases 7 and 8-10)."""
    lay = chip_smoke.paper_layout(*chip_smoke.PAPER["shared4"])
    return sorted({(n, c) for n, c, _ in
                   chip_smoke.gdn_train_shapes(chip_smoke.TRAIN_BATCH)
                   + chip_smoke.mt_gdn_shapes(lay, 16, train=True)
                   + chip_smoke.mt_gdn_shapes(lay, 2, train=True)})


_PLAN_SHAPES = _train_path_shapes() + [
    (n, c) for n in (1, 5, 4099) for c in (1, 28, 127, 169, 300,
                                           MAX_CHANNELS)]


def _check_mma_plan_covers(n, c, plan):
    """The tensor cores' warp tiles: P1's and P2's cover every m16 x n8
    tile of a tile's rows x C8 once, P3's take at most the block's warps
    and cover every m16 x n8 tile of o x j' once, its stores every (o, j)
    of the partials once; every column a product reads within the
    padded rows."""
    warps, tr = plan.threads // 32, plan.tile_rows
    c8, m3, n3 = _cdiv(c, 8) * 8, _cdiv(c, 16), _cdiv(c + 1, 8)
    hits = np.zeros((tr // 16, c8 // 8), np.int64)
    for r0, nts in _mma_warp_tiles(tr, c):
        assert nts and len(nts) <= BWD_MMA_NT
        hits[r0 // 16, nts] += 1
    assert (hits == 1).all()
    assert bwd_mma_p3_fits(c, plan.threads)
    p3 = _mma_p3_tiles(c, plan.threads)
    assert 1 <= len(p3) <= warps
    hits = np.zeros((m3, n3), np.int64)
    for m0, nts in p3:
        assert nts and len(nts) <= bwd_mma_p3_nt(plan.threads)
        hits[m0 // 16, nts] += 1
    assert (hits == 1).all()
    stored = np.zeros((c, bwd_partial_stride(c)), np.int64)
    for m0, nts in p3:
        for q in nts:
            stored[m0:m0 + 16, 8 * q:8 * q + 8] += 1
    assert (stored == 1).all()
    assert max(c8, 16 * m3, 8 * n3) <= bwd_mma_stride(c)
    assert c8 <= bwd_mma_fstride(c)


@pytest.mark.parametrize("n,c", _PLAN_SHAPES)
def test_backward_plan_covers_rows_and_partials_once_and_fits(n, c):
    """For the plan and, where the tensor cores have one, the other path's
    too (`chip_smoke.backward_paths`): every row in exactly one tile of
    one block, every block at least one tile; every (o, j) of dgamma and
    dbeta stored by exactly one of
    P3's warp tiles (`_check_mma_plan_covers` on the tensor cores); the
    block's shared memory, its residency and the partials within the
    card's and the plan's limits; on the CUDA cores the kernel's reads
    past a row's end (P2's last warp column of gamma, P3's of u and x^2)
    within the block's shared memory or gamma's padded copy."""
    for plan in chip_smoke.backward_paths(n, c):
        _check_plan_covers(n, c, plan)


def _check_plan_covers(n, c, plan):
    check_backward_plan(n, c, plan)
    tiles = backward_block_tiles(n, plan)
    assert len(tiles) == plan.blocks and all(tiles)
    covered = sorted(r for block in tiles for row0, rows in block
                     for r in range(row0, row0 + rows))
    assert covered == list(range(n))
    smem = gdn_backward_smem_bytes(c, plan.tile_rows, plan.smem_gamma,
                                   plan.mma)
    assert smem <= MAX_SMEM
    per_sm = bwd_resident_per_sm(c, plan.tile_rows, plan.smem_gamma,
                                 plan.threads, plan.mma)
    assert 1 <= per_sm and plan.blocks <= SMS * per_sm
    assert 4 * bwd_partial_floats(c, plan.blocks) <= \
        max(BWD_PARTIAL_MAX_BYTES, 4 * c * bwd_partial_stride(c))
    if plan.mma:
        _check_mma_plan_covers(n, c, plan)
        return
    hits = np.zeros((c, bwd_partial_stride(c)), np.int64)
    for o0, o1, j0, j1 in backward_partial_tiles(c):
        hits[o0:o1, j0:j1] += 1
    assert (hits == 1).all()
    ls, tr = bwd_row_stride(c), plan.tile_rows
    if plan.split:
        assert plan.rm == 2 and plan.smem_gamma
        assert bwd_p3_tiles(c) * plan.split <= plan.threads // 32
        assert bwd_p3_tiles(c) * 1024 <= 4 * tr * ls
    c4 = _cdiv(c, 4) * 4
    gamma_read = (c4 - 1) * ls + 32 * _cdiv(c, 32)
    gamma_room = (bwd_gamma_rows(c) * ls + 4 * tr * ls if plan.smem_gamma
                  else bwd_gamma_pad_floats(c))
    assert gamma_read <= gamma_room
    # u is followed by x, x^2 by u: P3 reads at most a row and 32 past
    assert (tr - 1) * ls + 32 * _cdiv(c + 1, 32) <= 2 * tr * ls


@pytest.mark.parametrize("c", sorted({c for _, c in _train_path_shapes()}))
def test_backward_stages_gamma_at_every_train_path_c(c):
    """At the train path's C (1-168) the CUDA cores' plan keeps gamma in
    shared memory beside tiles of at least 32 rows; two blocks of 256
    threads an SM (C <= 63, P3's sums kept by all 8 warps), one of 512
    (C = 100: P3's 16 warp tiles a warp each, its sums kept), or one of
    256 where gamma leaves no room for two (C = 168); P1 gives at least 6
    of 8 warps (12 of 16) a warp tile (C = 168: 6 warp tiles of 28
    channels)."""
    plan = gdn_backward_plan(1 << 20, c, mma=False)
    assert plan.smem_gamma and plan.tile_rows >= 32
    per_sm = bwd_resident_per_sm(c, plan.tile_rows, plan.smem_gamma,
                                 plan.threads)
    want = ((2, 256, 8 // bwd_p3_tiles(c)) if c <= 63 else (1, 512, 1)
            if c <= 127 else (1, 256, 0))
    assert (per_sm, plan.threads, plan.split) == want
    assert plan.blocks == SMS * per_sm
    assert plan.tile_rows // (8 * plan.rm) * bwd_gamma_rows(c) // 28 >= \
        6 * plan.threads // 256


def test_backward_covers_every_c_the_forward_launches_at():
    assert BWD_MAX_CHANNELS >= MAX_CHANNELS
    assert not gdn_backward_plan(4099, MAX_CHANNELS).smem_gamma
    with pytest.raises(ValueError):
        gdn_backward_plan(64, BWD_MAX_CHANNELS + 1)


@pytest.mark.parametrize("plan", [
    GDNBackwardPlan(2, 40, 1, True, 0, 512, True),
    GDNBackwardPlan(4, 32, 1, True, 0, 512, True),
    GDNBackwardPlan(2, 32, 1, False, 0, 512, True),
    GDNBackwardPlan(2, 32, 1, True, 1, 512, True),
    GDNBackwardPlan(2, 32, 1, True, 0, 256, True),
    GDNBackwardPlan(2, 64, 1, True, 0, 512, True),
    GDNBackwardPlan(2, 16, 1, True, 0, 384, True),
    GDNBackwardPlan(2, 16, 1, True, 0, 128, True),
    GDNBackwardPlan(2, 32, 0, True, 0, 512, True),
    GDNBackwardPlan(2, 32, 200, True, 0, 512, True),
    GDNBackwardPlan(3, 64, 1, True), GDNBackwardPlan(4, 48, 1, True),
    GDNBackwardPlan(4, 16, 1, True), GDNBackwardPlan(4, 64, 0, True),
    GDNBackwardPlan(4, 64, 200, True), GDNBackwardPlan(4, 256, 1, True),
    GDNBackwardPlan(2, 16, 1, 1), GDNBackwardPlan(4, 64, 1, True, 1),
    GDNBackwardPlan(2, 32, 1, False, 1), GDNBackwardPlan(2, 32, 1, True, 9),
    GDNBackwardPlan(2, 32, 1, True, 1),
    GDNBackwardPlan(2, 64, 1, True, 0, 512),
    GDNBackwardPlan(2, 32, 1, True, 1, 512),
    GDNBackwardPlan(2, 64, 1, True, 1, 384)])
def test_check_backward_plan_refuses_plans_without_a_kernel(plan):
    """On the tensor cores (C = 100): tiles off 16 rows, 4 rows a thread,
    gamma in global memory, a split, 256 threads (P3's 14 warp tiles
    need more than 8 warps), 64-row tiles (too much shared memory), 384
    threads, 128 threads, no blocks or more blocks than tiles. On the CUDA
    cores: rows
    per thread other than 2 or 4, tiles off the warps' rows, no blocks or
    more blocks than tiles, too much shared memory at C = 100, a flag that
    is not a bool; P3's sums kept with 4 rows a thread, with gamma in
    global memory, by 9 warps, or by more warps than the block has (C =
    100: 16 warp tiles); 512 threads without a split, with tiles too small
    for P3's sums, 384 threads."""
    with pytest.raises(ValueError):
        check_backward_plan(4099, 100, plan)


# --- (d) the tensor cores' arithmetic and layout -------------------------

def test_tf32_rounding_is_to_nearest_ties_away_with_13_bits_clear():
    """`_tf32` (cvt.rna.tf32.f32): ties 1 +- 2^-11 go away from zero, a
    value below the tie goes down; on random values of every exponent the
    low 13 bits are clear and the result is the nearer of the two TF32
    values around it (of 11 significant bits)."""
    one = np.float32(1)
    tie, below = one + np.float32(2 ** -11), np.nextafter(
        one + np.float32(2 ** -11), one)
    got = _tf32(np.array([tie, -tie, below, -below, 0, -0.0], np.float32))
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1, -1, 0, 0]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) * 2.0 ** rng.integers(-60, 60, 4096)).astype(
        np.float32)
    t = _tf32(a)
    assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    down = (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    up = (down.view(np.uint32) + np.uint32(0x2000)).view(np.float32)
    err = np.abs(t.astype(np.float64) - a)
    assert (err <= np.minimum(np.abs(down.astype(np.float64) - a),
                              np.abs(up.astype(np.float64) - a))).all()
    assert (err <= 2.0 ** -11 * np.abs(a.astype(np.float64))).all()


@pytest.mark.parametrize("c", sorted({c for _, c in _train_path_shapes()}
                                     | {BWD_MAX_CHANNELS}))
def test_3xtf32_product_is_within_its_bound_of_float64(c):
    """The 3xTF32 product with float32 accumulation (`_product_3xtf32`, as
    the kernel's mma3) at every C of the rgb and shared4 train paths and
    at BWD_MAX_CHANNELS, for P1's x^2 gamma^T, P2's u @ gamma and P3's
    u^T x^2 (K = 64 rows): within (13 + 4 ceil(K / 8)) 2^-24 sum_k
    |a_k b_k| of the float64 product at every output. The split drops
    a_lo b_lo and the two splits' residues, at most ~3 2^-22 |a b| a
    product; each of the 3 ceil(K / 8) MMAs rounds the float32 sum once."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(64, c)).astype(np.float32)
    u = (rng.normal(size=(64, c)) * 1e-3).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    x2 = x * x
    for a, b in ((x2, gamma.T), (u, gamma), (u.T, x2)):
        got = _product_3xtf32(a, b).astype(np.float64)
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        bound = ((13 + 4 * _cdiv(a.shape[1], 8)) * 2.0 ** -24
                 * (np.abs(a64) @ np.abs(b64)))
        assert (np.abs(got - a64 @ b64) <= bound).all()
    # one TF32 product (no split) is ~2^11 times further off
    one = (_tf32(x2).astype(np.float64) @ _tf32(gamma.T).astype(np.float64))
    exact = x2.astype(np.float64) @ gamma.T.astype(np.float64)
    three = _product_3xtf32(x2, gamma.T).astype(np.float64)
    assert np.abs(three - exact).max() * 64 < np.abs(one - exact).max()


def _bank_pairs(ls, rows, cols):
    """The 8-byte bank pair (of 16) of each (hi, lo) element read."""
    return _sw(rows, cols, ls) % 16


@pytest.mark.parametrize("c", [3, 10, 21, 42, 50, 100, 127])
def test_mma_fragments_read_distinct_bank_pairs(c):
    """Each 8-byte load of a fragment (gid = lane / 4, tig = lane % 4; the
    card serves a warp's 8-byte loads a half-warp at a time): the 16 lanes
    of a half-warp read 16 distinct bank pairs in every pattern the kernel
    has, at any m16, n8 and k8 offset: A (rows gid (+8), columns tig (+4):
    P1's x^2, P2's u) and P1's B (gamma^T: rows gid, columns tig (+4));
    P2's and P3's B and P3's A (rows tig (+4), columns gid (+8): gamma,
    x^2, u^T); and the epilogues' float2 reads of x and g (rows gid (+8),
    columns 2 tig)."""
    lf = bwd_mma_fstride(c)
    assert lf % 16 == 8
    for r0 in (0, 8, 16):
        f = ((r0 + np.arange(32) // 4) * lf // 2 + np.arange(32) % 4) % 16
        assert len(set(f[:16])) == len(set(f[16:])) == 16
    ls = bwd_mma_stride(c)
    assert ls % 8 == 4
    lanes = np.arange(32)
    gid, tig = lanes // 4, lanes % 4
    for base_r in range(0, 64, 8):
        for base_c in range(0, ls - 8, 8):
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                if base_c + dc + 4 > ls:
                    continue
                a = _bank_pairs(ls, base_r + gid + dr, base_c + tig + dc)
                for half in (a[:16], a[16:]):
                    assert len(set(half)) == 16
            for dr, dc in ((0, 0), (4, 0), (0, 8), (4, 8)):
                if base_c + dc + 8 > ls:
                    continue
                b = _bank_pairs(ls, base_r + tig + dr, base_c + gid + dc)
                for half in (b[:16], b[16:]):
                    assert len(set(half)) == 16


@pytest.mark.parametrize("n,c", _train_path_shapes())
def test_backward_takes_the_tensor_cores_from_bwd_mma_min_channels(n, c):
    """At every train-path shape the plan is the tensor cores' where they
    have a plan (C <= 127) and C is at least BWD_MMA_MIN_CHANNELS or the
    rows at most BWD_MMA_NARROW_ROWS, else the CUDA cores': the rgb step's
    C = 3 and shared4's C = 1-21 at 131072 rows and more, and shared4's
    C = 168 (split gamma does not fit a block). The tensor cores' plan:
    256 threads two blocks an SM where P3's warp tiles fit 8 warps (C <=
    63), else 512 threads one block (C = 100); 16-row tiles where those
    leave each block one tile at most (1024 rows at C = 100), else 64 rows
    (C <= 42) or 32."""
    plan = gdn_backward_plan(n, c)
    assert plan.mma == bwd_takes_mma(n, c)
    assert plan.mma == ((c >= BWD_MMA_MIN_CHANNELS or n <= BWD_MMA_NARROW_ROWS)
                        and c <= 127)
    if not plan.mma:
        return
    per_sm = bwd_resident_per_sm(c, plan.tile_rows, True, plan.threads, True)
    assert (plan.threads, per_sm) == ((256, 2) if c < 64 else (512, 1))
    fits = (16, 32, 48, 64) if c <= 42 else (16, 32, 48)
    one_tile = [t for t in fits if -(-n // t) <= SMS * per_sm]
    assert plan.tile_rows == (one_tile[0] if one_tile
                              else 64 if c <= 42 else 32)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::gdn_backward_kernel<float, 2, true, true, "
     "256>(float const*, ...)", "gdn_backward"),
    ("void (anonymous namespace)::gdn_backward_mma_kernel<__nv_bfloat16, "
     "512>(__nv_bfloat16 const*, ...)", "gdn_backward"),
    ("void (anonymous namespace)::gdn_backward_sum_kernel(float const*, ...)",
     "gdn_backward_aux"),
    ("void (anonymous namespace)::gdn_backward_pad_kernel(float const*, ...)",
     "gdn_backward_aux")])
def test_chip_smoke_counts_either_rows_kernel_as_a_backward_launch(name,
                                                                   kind):
    """chip_smoke's `kernel_kind`: a launch's rows kernel, on the CUDA
    cores or the tensor cores, is its one "gdn_backward" record; the sum
    and the padding of gamma are its aux records."""
    assert chip_smoke.kernel_kind(name) == kind


# --- (e) routing on the CPU --------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_function_on_the_cpu_takes_the_plain_backward(inverse):
    """GDNFunction's gradients on CPU tensors are `gdn_backward_plain`'s,
    bitwise, and launch no kernel."""
    x, g, gamma, beta = _case(333, 21, seed=9)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    before = (gdn_cuda.launches, gdn_backward_cuda.launches)
    # a strided gradient, as the next layer's backward may hand over
    gt = torch.from_numpy(np.ascontiguousarray(g.T)).t()
    GDNFunction.apply(*args, inverse).backward(gt)
    assert (gdn_cuda.launches, gdn_backward_cuda.launches) == before
    want = gdn_backward_plain(torch.from_numpy(x), gt,
                              torch.from_numpy(gamma), torch.from_numpy(beta),
                              inverse)
    for a, w in zip(args, want):
        assert torch.equal(a.grad, w)


def test_gdn_backward_cuda_refuses_cpu_tensors_and_wrong_types():
    x, g, gamma, beta = map(torch.from_numpy, _case(64, 10, seed=4))
    before = gdn_backward_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdn_backward_cuda(x, g, gamma, beta, False)
    for args in ((x.half(), g.half(), gamma, beta),
                 (x, g.to(torch.bfloat16), gamma, beta),
                 (x.double(), g.double(), gamma, beta),
                 (x, g, gamma.double(), beta),
                 (x, g, gamma, beta.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            gdn_backward_cuda(*args, False)
    for args in ((x, g[:-1], gamma, beta), (x, g, gamma[:-1], beta),
                 (x, g, gamma, beta[:-1])):
        with pytest.raises(ValueError, match="do not match"):
            gdn_backward_cuda(*args, False)
    assert gdn_backward_cuda.launches == before
