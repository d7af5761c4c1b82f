"""The backward of (I)GDN (mmnc_tpu/ops/gdn_pallas.py:_bwd, the custom VJP
of gdn_pallas_2d) in mmnc_tpu_torch on the CPU: the plain version
`gdn_backward_plain` against JAX's VJP (the Pallas forward in interpret
mode), csrc/gdn_backward.cu's plan emulated in torch (row tiles on
persistent blocks, shared-memory layout, per-block partials and their
fixed-order sum) against JAX's `_bwd`, the plan's coverage and shared
memory, and the routing of `GDNFunction` on the CPU.

Inputs come from a numpy seed and go to both packages as the same arrays.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mmnc_tpu.ops.gdn_pallas import _bwd, gdn_pallas_2d

from mmnc_tpu_torch.ops.gdn import (BWD_MAX_CHANNELS, BWD_PARTIAL_MAX_BYTES,
                                   MAX_CHANNELS, MAX_SMEM, SMS,
                                   GDNBackwardPlan, GDNFunction,
                                   backward_block_tiles,
                                   backward_partial_tiles,
                                   bwd_gamma_pad_floats,
                                   bwd_gamma_rows, bwd_p3_tiles,
                                   bwd_partial_floats, bwd_partial_stride,
                                   bwd_resident_per_sm, bwd_row_stride,
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
    rm, tr, blocks, smem_gamma, split, _ = plan
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


# (n, c, plan or None for gdn_backward_plan's): the path's C at ragged row
# counts; blocks walking several tiles, 2 rows a thread, gamma read from
# its padded global copy, C = 655 (the forward's widest)
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
    (200, MAX_CHANNELS, None)]


@pytest.mark.parametrize("n,c,plan", _EMULATED)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_plan_as_emulated_matches_jax_bwd(n, c, plan, inverse):
    """The kernel's indexing, emulated (`_emulate_backward`), computes the
    plain version's gradients in float64 (no NaN from an unwritten word
    reaches one), JAX's `_bwd` within the plain version's tolerance, and
    stores every partial value a tile of its block."""
    x, g, gamma, beta = _case(n, c, seed=n + c)
    plan = plan or gdn_backward_plan(n, c)
    check_backward_plan(n, c, plan)
    dx, dgamma, dbeta, stores = _emulate_backward(x, g, gamma, beta,
                                                  inverse, plan)
    counts = [len(t) for t in backward_block_tiles(n, plan)]
    want_stores = (torch.ones(plan.blocks) if plan.split
                   else torch.tensor(counts))
    assert (stores == want_stores[:, None, None]).all()
    want = gdn_backward_plain(*(torch.from_numpy(a).double()
                                for a in (x, g, gamma, beta)), inverse)
    for got, w in zip((dx, dgamma, dbeta), want):
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


@pytest.mark.parametrize("n,c", _PLAN_SHAPES)
def test_backward_plan_covers_rows_and_partials_once_and_fits(n, c):
    """Every row in exactly one tile of one block, every block at least one
    tile; every (o, j) of dgamma and dbeta stored by exactly one of P3's
    warp tiles; the block's shared memory, its residency and the partials
    within the card's and the plan's limits; the kernel's reads past a
    row's end (P2's last warp column of gamma, P3's of u and x^2) within
    the block's shared memory or gamma's padded copy."""
    plan = gdn_backward_plan(n, c)
    check_backward_plan(n, c, plan)
    tiles = backward_block_tiles(n, plan)
    assert len(tiles) == plan.blocks and all(tiles)
    covered = sorted(r for block in tiles for row0, rows in block
                     for r in range(row0, row0 + rows))
    assert covered == list(range(n))
    hits = np.zeros((c, bwd_partial_stride(c)), np.int64)
    for o0, o1, j0, j1 in backward_partial_tiles(c):
        hits[o0:o1, j0:j1] += 1
    assert (hits == 1).all()
    smem = gdn_backward_smem_bytes(c, plan.tile_rows, plan.smem_gamma)
    assert smem <= MAX_SMEM
    per_sm = bwd_resident_per_sm(c, plan.tile_rows, plan.smem_gamma,
                                 plan.threads)
    assert 1 <= per_sm and plan.blocks <= SMS * per_sm
    assert 4 * bwd_partial_floats(c, plan.blocks) <= \
        max(BWD_PARTIAL_MAX_BYTES, 4 * c * bwd_partial_stride(c))
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
    """At the train path's C (1-168) gamma sits in shared memory beside
    tiles of at least 32 rows; two blocks of 256 threads an SM (C <= 63,
    P3's sums kept by all 8 warps), one of 512 (C = 100: P3's 16 warp
    tiles a warp each, its sums kept), or one of 256 where gamma leaves
    no room for two (C = 168); P1 gives at least 6 of 8 warps (12 of 16)
    a warp tile (C = 168: 6 warp tiles of 28 channels)."""
    plan = gdn_backward_plan(1 << 20, c)
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
    """Rows per thread other than 2 or 4, tiles off the warps' rows, no
    blocks or more blocks than tiles, too much shared memory at C = 100,
    a flag that is not a bool; P3's sums kept with 4 rows a thread, with
    gamma in global memory, by 9 warps, or by more warps than the block
    has (C = 100: 16 warp tiles); 512 threads without a split, with tiles
    too small for P3's sums, 384 threads."""
    with pytest.raises(ValueError):
        check_backward_plan(4099, 100, plan)


# --- (d) routing on the CPU --------------------------------------------------

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
