"""mmnc_tpu_torch ops against mmnc_tpu on the CPU: bounds, rounding, conv
geometry, init, and the plain versions of the two kernels (GDN and
deconv+IGDN) against the Pallas kernels in interpret mode.

Inputs come from a numpy seed and go to both packages as the same arrays.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.ops import layers as jl
from mmnc_tpu.ops.bound import lower_bound as j_lower_bound
from mmnc_tpu.ops.bound import upper_bound as j_upper_bound
from mmnc_tpu.ops.deconv_igdn_pallas import deconv_igdn_pallas
from mmnc_tpu.ops.gdn_pallas import gdn_pallas
from mmnc_tpu.ops.quant import quantize_round as j_quantize_round
from mmnc_tpu.utils.torch_import import (convert_conv_weight,
                                         convert_deconv_weight)

from mmnc_tpu_torch.ops import bound as tb
from mmnc_tpu_torch.ops import layers as tl
from mmnc_tpu_torch.ops import deconv_igdn as deconv_mod
from mmnc_tpu_torch.ops.deconv_igdn import (SPLITS, cin_slices, deconv_igdn,
                                            deconv_igdn_cuda,
                                            deconv_igdn_plain,
                                            deconv_weight_taps, l2_smem_bytes,
                                            launch_plan, parity_taps,
                                            tile_shape, tiled_blocks,
                                            tiled_config, tiled_smem_bytes)
from mmnc_tpu_torch.ops.gdn import (MAX_CHANNELS, MAX_SMEM, MAX_THREADS, SMS,
                                   GDNFunction, GDNPlan, check_plan, gdn,
                                   gdn_cuda, gdn_plain, gdn_plan,
                                   gdn_smem_bytes, out_slices,
                                   resident_per_sm, threads)
from mmnc_tpu_torch.ops.quant import quantize_round


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.fixture(scope="module")
def gdn_data():
    """The inputs of tests/test_gdn_pallas.py."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 16, 20)).astype(np.float32)
    gamma = (0.1 * np.eye(20) + 0.01 * rng.random((20, 20))).astype(np.float32)
    beta = (1 + 0.1 * rng.random(20)).astype(np.float32)
    return x, gamma, beta


# --- bound / quant -----------------------------------------------------------

def test_round_is_half_to_even_like_jnp_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.49999997, -0.49999997],
                 np.float32)
    want = np.array([-2, -2, 0, 0, 2, 2, 4, 0, 0], np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(x)), want)


def test_quantize_round_with_medians_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 4, 5, 6)) * 4).astype(np.float32)
    med = rng.normal(size=(6,)).astype(np.float32)
    got = quantize_round(_t(x), _t(med)).numpy()
    want = np.asarray(j_quantize_round(jnp.asarray(x), jnp.asarray(med)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(quantize_round(_t(x)).numpy(),
                                  np.asarray(j_quantize_round(jnp.asarray(x))))


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bound_values_and_gradients_match_jax(which):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64,)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    bound = 0.11
    t_fn = tb.lower_bound if which == "lower" else tb.upper_bound
    j_fn = j_lower_bound if which == "lower" else j_upper_bound

    xt = _t(x).requires_grad_(True)
    yt = t_fn(xt, bound)
    (dx_t,) = torch.autograd.grad(yt, xt, _t(g))
    yj, vjp = jax.vjp(lambda v: j_fn(v, bound), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))


# --- conv / deconv geometry and init ------------------------------------------

@pytest.mark.parametrize("kind,k,s,hw", [
    ("conv", 5, 2, 16), ("conv", 3, 1, 9), ("conv", 5, 2, 1),
    ("deconv", 5, 2, 8), ("deconv", 5, 2, 1)])
def test_conv_geometry_matches_jax(kind, k, s, hw):
    rng = np.random.default_rng(3)
    cin, cout = 5, 7
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    if kind == "conv":
        w = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.2
        layer = tl.Conv(cin, cout, k, s)
        want = jl.conv(jnp.asarray(x), jnp.asarray(convert_conv_weight(w)), s)
    else:
        w = rng.normal(size=(cin, cout, k, k)).astype(np.float32) * 0.2
        layer = tl.Deconv(cin, cout, k, s)
        want = jl.deconv(jnp.asarray(x), jnp.asarray(convert_deconv_weight(w)),
                         s)
    with torch.no_grad():
        layer.weight.copy_(_t(w))
        layer.bias.copy_(_t(bias))
        got = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want) + bias, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cls", [tl.Conv, tl.Deconv])
def test_init_is_variance_scaling_fan_in_uniform(cls):
    cin, cout, k = 40, 30, 5
    layer = cls(cin, cout, k, 2)
    layer.bias.data.fill_(1.0)
    layer.init_parameters(torch.Generator().manual_seed(0))
    limit = np.sqrt(1.0 / (k * k * cin))  # sqrt(3 * (1/3) / fan_in)
    w = layer.weight.detach().numpy()
    assert np.abs(w).max() <= limit
    # a uniform(-l, l) draw has std l/sqrt(3): 30000 draws land within 3%
    assert abs(w.std() / (limit / np.sqrt(3)) - 1) < 0.03
    assert not layer.bias.detach().any()
    again = cls(cin, cout, k, 2)
    again.init_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, layer.weight)


def test_gdn_init_matches_jax_effective_params():
    c = 6
    layer = tl.GDN(c)
    layer.init_parameters(None)
    gamma, beta = layer.effective()
    variables = jl.GDN().init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, c)))
    p = variables["params"]
    np.testing.assert_array_equal(layer.beta.detach().numpy(),
                                  np.asarray(p["beta"]))
    np.testing.assert_array_equal(layer.gamma.detach().numpy(),
                                  np.asarray(p["gamma"]))
    np.testing.assert_allclose(gamma.detach().numpy(), 0.1 * np.eye(c),
                               atol=1e-7)
    np.testing.assert_allclose(beta.detach().numpy(), np.ones(c), atol=1e-7)


# --- kernel 1: GDN ----------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_plain_matches_pallas_interpret(gdn_data, inverse):
    x, gamma, beta = gdn_data
    want = gdn_pallas(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                      inverse=inverse, interpret=True)
    got = gdn(_t(x), _t(gamma), _t(beta), inverse)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gdn_ragged_row_count_matches_pallas(gdn_data):
    """111*3 rows: not a multiple of any tile, as in test_gdn_pallas.py."""
    _, gamma, beta = gdn_data
    x = np.random.default_rng(1).normal(size=(1, 3, 111, 20)).astype(np.float32)
    want = gdn_pallas(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                      interpret=True)
    got = gdn(_t(x), _t(gamma), _t(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_matches_jax_module(inverse):
    rng = np.random.default_rng(4)
    c = 12
    x = rng.normal(size=(2, 5, 7, c)).astype(np.float32)
    beta_r = (1 + 0.2 * rng.random(c)).astype(np.float32)
    gamma_r = (0.3 * np.eye(c) + 0.05 * rng.random((c, c))).astype(np.float32)
    want = jl.GDN(inverse=inverse).apply(
        {"params": {"beta": jnp.asarray(beta_r), "gamma": jnp.asarray(gamma_r)}},
        jnp.asarray(x))
    layer = tl.GDN(c, inverse=inverse)
    with torch.no_grad():
        layer.beta.copy_(_t(beta_r))
        layer.gamma.copy_(_t(gamma_r))
        got = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_closed_form_backward_matches_autograd_and_jax(gdn_data, inverse):
    x, gamma, beta = gdn_data

    def grads(fn):
        args = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
        torch.sin(fn(*args)).sum().backward()
        return [a.grad.numpy() for a in args]

    got = grads(lambda a, g, b: gdn(a, g, b, inverse))
    plain = grads(lambda a, g, b: gdn_plain(a.reshape(-1, 20), g, b, inverse))
    want = jax.grad(
        lambda a, g, b: jnp.sum(jnp.sin(gdn_pallas(a, g, b, inverse=inverse,
                                                   interpret=True))),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                           jnp.asarray(beta))
    for a, b, c in zip(got, plain, want):
        np.testing.assert_allclose(a.reshape(b.shape), b, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4, atol=1e-5)


def test_gdn_function_gradcheck_float64():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(9, 4)), requires_grad=True)
    gamma = torch.tensor(0.1 * np.eye(4) + 0.02 * rng.random((4, 4)),
                         requires_grad=True)
    beta = torch.tensor(1 + rng.random(4), requires_grad=True)
    for inverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda a, g, b: GDNFunction.apply(a, g, b, inverse),
            (x, gamma, beta))


def test_gdn_cpu_takes_plain_version_and_cuda_wrapper_refuses_cpu(gdn_data):
    x, gamma, beta = gdn_data
    before = gdn_cuda.launches
    gdn(_t(x), _t(gamma), _t(beta))
    assert gdn_cuda.launches == before
    with pytest.raises(ValueError):
        gdn_cuda(_t(x).reshape(-1, 20), _t(gamma), _t(beta), False)


# --- kernel 2: deconv + (I)GDN ---------------------------------------------

def _deconv_case(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, shape[-1], cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    gamma = (rng.random((cout, cout)) * 0.1).astype(np.float32)
    beta = (1.0 + rng.random((cout,))).astype(np.float32)
    return x, w, b, gamma, beta


@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 7, 5, 8)])
def test_deconv_igdn_plain_matches_pallas_interpret(mode, shape):
    x, w, b, gamma, beta = _deconv_case(shape, 8)
    want = deconv_igdn_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(gamma) if mode else None,
        jnp.asarray(beta) if mode else None,
        mode=mode or "igdn", interpret=True)
    got = deconv_igdn(_t(x), _t(w), _t(b), _t(gamma) if mode else None,
                      _t(beta) if mode else None, mode=mode)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_deconv_weight_taps_is_the_importer_flip():
    w = np.random.default_rng(6).normal(size=(3, 4, 5, 5)).astype(np.float32)
    np.testing.assert_array_equal(deconv_weight_taps(_t(w)).numpy(),
                                  convert_deconv_weight(w))


def test_fused_layers_equal_unfused_on_cpu():
    """run_layers' no-grad fused deconv+IGDN path is the same function as
    the layer-by-layer path it replaces."""
    from mmnc_tpu_torch.models.heads import DecoderHead

    head = DecoderHead(8, 3)
    gen = torch.Generator().manual_seed(1)
    for m in head.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(gen)
    x = _t(np.random.default_rng(7).normal(size=(1, 2, 2, 8))).permute(0, 3, 1, 2)
    unfused = head(x).detach()
    with torch.no_grad():
        fused = head(x)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_deconv_igdn_rejects_bad_mode_and_cpu_in_cuda_wrapper():
    x, w, b, gamma, beta = _deconv_case((1, 2, 2, 4), 4)
    with pytest.raises(ValueError):
        deconv_igdn_plain(_t(x), _t(w), _t(b), _t(gamma), _t(beta), "relu")
    with pytest.raises(ValueError):
        deconv_igdn_plain(_t(x), _t(w), _t(b), None, None, "igdn")
    before = deconv_igdn_cuda.launches
    with pytest.raises(ValueError):
        deconv_igdn_cuda(_t(x), _t(w), _t(b), _t(gamma), _t(beta), "igdn")
    assert deconv_igdn_cuda.launches == before


# --- launch plan of the deconv+IGDN kernel -------------------------------

@pytest.mark.parametrize("shape,plan", [
    ((8, 1, 1, 128, 100), ("split", 1, 1, 8)),
    ((8, 2, 2, 100, 100), ("split", 2, 2, 8)),
    ((8, 4, 4, 100, 100), ("split", 4, 4, 8))])
def test_launch_plan_splits_the_latent_stages(shape, plan):
    """g_s's three deconv+IGDN stages at batch 8: a cluster split-K, one
    image per cluster of 8, within half the H100's 132 SMs (one wave)."""
    b, h, w, _, _ = shape
    assert launch_plan(*shape) == plan
    _, t, _, s = plan
    assert b * -(-h // t) * -(-w // t) * s <= 132 // 2


@pytest.mark.parametrize("shape,tile", [
    ((8, 16, 16, 100, 50), (4, 8)), ((8, 32, 32, 50, 50), (8, 16)),
    ((8, 64, 64, 50, 3), (8, 16)), ((8, 128, 128, 3, 3), (16, 32))])
def test_launch_plan_keeps_the_tiles_of_the_wide_stages(shape, tile):
    """The rgb decoder head's stages at batch 8 take the tiled kernel with
    256 blocks: one per tile and parity plane, or, at Cout 3, one per tile
    with its four planes."""
    assert launch_plan(*shape) == ("tiled", *tile, 1)
    assert tile_shape(*shape) == tile
    assert tiled_blocks(*shape[:3], *tile, shape[4]) == 256


@pytest.mark.parametrize("cin", [3, 50, 100, 128])
@pytest.mark.parametrize("splits", SPLITS)
def test_cin_slices_cover_every_channel_once(cin, splits):
    slices = cin_slices(cin, splits)
    assert len(slices) == splits
    covered = [c for start, size in slices for c in range(start, start + size)]
    assert covered == list(range(cin))
    sizes = [size for _, size in slices]
    assert max(sizes) - min(sizes) <= (1 if cin % splits else 0)
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("shape", [(8, 2, 2, 100, 50), (8, 2, 2, 100, 200),
                                   (8, 2, 2, 100, 16)])
def test_launch_plan_keeps_tiles_where_the_split_kernel_has_none(shape):
    """Cout not a multiple of 4, above 128 or below 32."""
    assert launch_plan(*shape)[0] == "tiled"


def test_cin_slices_of_100_over_8_are_13_and_12():
    assert [size for _, size in cin_slices(100, 8)] == [13] * 4 + [12] * 4


# --- the tiled kernel's plan, grid and arithmetic, as the .cu computes them

def _cdiv(a, b):
    return -(-a // b)


def _chip_smoke_deconv_shapes():
    """Every distinct deconv+IGDN launch shape chip_smoke.py checks: the
    rgb decompress (`deconv_path_shapes`) and shared4's, mixed's and
    disjoint's (`mt_deconv_shapes`) at batch 1, 2, 4, 8 and 16, g_s's last
    deconv, the split kernel's extra shapes, and phase 6's conv 192 and
    300 models."""
    import chip_smoke

    shapes = []
    for b in (1, 2, 4, 8, 16):
        shapes += chip_smoke.deconv_path_shapes(b)
        shapes += [(b, 8, 8, chip_smoke.CONV, chip_smoke.CONV, None)]
        for name in ("shared4", "mixed", "disjoint"):
            shapes += chip_smoke.mt_deconv_shapes(
                chip_smoke.paper_layout(*chip_smoke.PAPER[name]), b)
    shapes += chip_smoke.split_extra_shapes() + chip_smoke.wide_deconv_shapes()
    return sorted(set(shapes), key=str)


_SMOKE_DECONV_SHAPES = _chip_smoke_deconv_shapes()


def _output_writes(b, h, w, cout, plan):
    """How many times the launch of `plan` writes each output pixel of one
    image ((2h, 2w) counts; every image's block rows are the same), its
    grid and block indices taken as csrc/deconv_igdn.cu takes them."""
    variant, ta, tb, splits = plan
    ys, xs = [], []
    if variant == "tiled" and deconv_mod.planes(cout) == 4:
        # grid (tiles, B): block x = tile, the thread's plane its parity
        tiles_w = _cdiv(w, tb)
        tile = np.repeat(np.arange(_cdiv(h, ta) * tiles_w), 4)
        q = np.tile(np.arange(4), len(tile) // 4)
    elif variant == "tiled":  # grid (4 x tiles, B); block x = 4 tile + parity
        tiles_w = _cdiv(w, tb)
        bx = np.arange(4 * _cdiv(h, ta) * tiles_w)
        q, tile = bx & 3, bx >> 2
    if variant == "tiled":
        a0, b0 = tile // tiles_w * ta, tile % tiles_w * tb
        pos = np.arange(ta * tb)
        ia = a0[:, None] + pos[None] // tb
        ib = b0[:, None] + pos[None] % tb
        keep = (ia < h) & (ib < w)  # the epilogue's test
        ys = (2 * ia + (q >> 1)[:, None])[keep]
        xs = (2 * ib + (q & 1)[:, None])[keep]
    elif variant == "split":  # grid (S, tiles, B); rank r: p = r + i S
        t, tiles_w = ta, _cdiv(w, ta)
        pix, npr = 4 * t * t, _cdiv(4 * t * t, splits)
        for tile in range(_cdiv(h, t) * tiles_w):
            a0, b0 = tile // tiles_w * t, tile % tiles_w * t
            for r in range(splits):
                for i in range(npr):
                    p = r + i * splits
                    gy, gx = 2 * a0 + p // (2 * t), 2 * b0 + p % (2 * t)
                    if p < pix and gy < 2 * h and gx < 2 * w:
                        ys.append(gy)
                        xs.append(gx)
    else:  # tiled_l2: grid (tiles_w, tiles_h, B), all 4 parities a block
        for a0 in range(0, h, ta):
            for b0 in range(0, w, tb):
                for p in range(4 * ta * tb):
                    gy, gx = 2 * a0 + p // (2 * tb), 2 * b0 + p % (2 * tb)
                    if gy < 2 * h and gx < 2 * w:
                        ys.append(gy)
                        xs.append(gx)
    count = np.zeros((2 * h, 2 * w), np.int64)
    np.add.at(count, (np.asarray(ys, np.int64), np.asarray(xs, np.int64)), 1)
    return count


@pytest.mark.parametrize("shape", _SMOKE_DECONV_SHAPES, ids=str)
def test_deconv_plan_of_every_checked_shape_covers_the_output_once(shape):
    """Each launch shape chip_smoke.py checks: its plan has a kernel (the
    wrapper's test), fits in a block's shared memory, writes every output
    pixel of every parity once, and, where it is the tiled kernel, gives at
    least min(132, B x 4 x ceil(H W / 8)) blocks."""
    b, h, w, cin, cout, mode = shape
    plan = launch_plan(b, h, w, cin, cout)
    variant, ta, tb, splits = plan
    if variant == "tiled":
        config = tiled_config(b, h, w, cin, cout, ta, tb)
        assert config is not None and splits == 1
        assert config.smem_bytes <= deconv_mod.MAX_SMEM
        assert 32 <= config.threads <= deconv_mod.TILED_MAX_THREADS
        assert tiled_blocks(b, h, w, ta, tb, cout) >= min(
            132, b * 4 * _cdiv(h * w, 8))
    elif variant == "tiled_l2":
        assert splits == 1
        assert l2_smem_bytes(ta, tb, cin, cout, mode) <= deconv_mod.MAX_SMEM
    else:
        assert variant == "split" and splits in SPLITS and ta == tb
    assert (_output_writes(b, h, w, cout, plan) == 1).all()


def _emulate_tiled(x, w, bias, gamma, beta, mode, ta, tb):
    """csrc/deconv_igdn.cu's tiled kernel run block by block and thread by
    thread on numpy arrays in float64: the same plan (`tiled_config`),
    grid, planes, tap ranges, flat shared-memory addresses (unwritten words
    NaN), copies, thread roles, slices and epilogue. Returns (out, stores
    per output value)."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    c = tiled_config(bsz, h, wd, cin, cout, ta, tb)
    kp, slices, chunk, nv = c.p, c.slices, c.chunk, c.nv
    cq, nq = _cdiv(cout, 4), deconv_mod.planes(cout)
    cp, npos, wx = 4 * cq, ta * tb, tb + 2
    hw = (ta + 2) * wx
    stage_floats = nv * chunk * cp
    ys_floats = nq * npos * cp * (slices + 2 if slices > 1 else 2)
    x_at = max((2 if chunk < cin else 1) * stage_floats, ys_floats)
    g_at = x_at + 4 * _cdiv(hw * cin, 4)
    b_at = g_at + cout * cp
    assert c.smem_bytes == 4 * (b_at + cp)
    wf, gf = w.reshape(-1), gamma.reshape(-1)
    out = np.full((bsz, 2 * h, 2 * wd, cout), np.nan)
    stores = np.zeros(out.shape, np.int64)
    tiles_w = _cdiv(wd, tb)
    base = npos // kp * cq
    nchunks = _cdiv(cin, chunk)
    width = 4 if cout % 4 == 0 else 2 if cout % 2 == 0 else 1
    for n in range(bsz):
        for bx in range(4 // nq * _cdiv(h, ta) * tiles_w):
            smem = np.full(c.smem_bytes // 4, np.nan)
            tile = bx if nq == 4 else bx >> 2
            a0, b0 = tile // tiles_w * ta, tile % tiles_w * tb
            pl, slot = [], 0  # (dh, dw, t_lo, nt, s_lo, ns, first slot)
            for u in range(nq):
                q = u if nq == 4 else bx & 3
                t_lo, nt = parity_taps(q >> 1, a0, ta, h)
                s_lo, ns = parity_taps(q & 1, b0, tb, wd)
                pl.append((q >> 1, q & 1, t_lo, nt, s_lo, ns, slot))
                slot += nt * ns
            assert slot <= nv

            def stage(k):
                c0 = k * chunk
                copies = min(chunk, cin - c0) * (cout // width)
                for dh, dw, t_lo, nt, s_lo, ns, slot0 in pl:
                    for slot in range(nt * ns):
                        t, s = t_lo + slot // ns, s_lo + slot % ns
                        src = (((2 * t + dh) * 5 + 2 * s + dw) * cin
                               + c0) * cout
                        dst = (k & 1) * stage_floats + (slot0 + slot) * \
                            chunk * cp
                        for tid in range(c.threads):
                            ci, o = divmod(tid, cout // width)
                            for e in range(tid, copies, c.threads):
                                at = dst + ci * cp + o * width
                                smem[at:at + width] = \
                                    wf[src + width * e:src + width * (e + 1)]
                                ci, o = divmod(ci * (cout // width) + o
                                               + c.threads, cout // width)

            stage(0)
            if mode:
                for i in range(cout * cout):
                    o, j = divmod(i, cout)
                    smem[g_at + j * cp + o] = gf[i]
                smem[b_at:b_at + cout] = beta
            for tid in range(c.threads):  # (ci, r, col) kept by adds
                ci, r, col = tid % cin, tid // cin // wx, tid // cin % wx
                p_step, ci_step = divmod(c.threads, cin)
                for i in range(tid, hw * cin, c.threads):
                    assert (r * wx + col) * cin + ci == i
                    ia, ib = a0 - 1 + r, b0 - 1 + col
                    inside = 0 <= ia < h and 0 <= ib < wd
                    smem[x_at + ci * hw + r * wx + col] = (
                        x[n, ia, ib, ci] if inside else 0.0)
                    ci += ci_step
                    carry = int(ci >= cin)
                    ci -= cin * carry
                    col += p_step % wx + carry
                    r += p_step // wx
                    if col >= wx:
                        col -= wx
                        r += 1
            roles = []
            for tid in range(c.threads):
                sl, rem = divmod(tid, nq * base)
                u, g = rem // base, rem % base // cq
                qd = rem - u * base - g * cq
                if sl >= slices:
                    continue
                bv = np.array([bias[4 * qd + j] if 4 * qd + j < cout else 0.0
                               for j in range(4)])
                roles.append((sl, u, g, qd, np.tile(
                    bv if slices == 1 else np.zeros(4), (kp, 1))))
            for k in range(nchunks):
                if k + 1 < nchunks:
                    stage(k + 1)
                c0 = k * chunk
                kc = min(chunk, cin - c0)
                for sl, u, g, qd, acc in roles:
                    dh, dw, t_lo, nt, s_lo, ns, slot0 = pl[u]
                    xoff = g * kp // tb * wx + g * kp % tb
                    ws = (k & 1) * stage_floats + slot0 * chunk * cp + 4 * qd
                    xs = x_at + c0 * hw + (t_lo + dh) * wx + s_lo + dw + xoff
                    for ci in range(sl, kc, slices):
                        for ti in range(nt):
                            at = xs + ci * hw + ti * wx
                            xr = smem[at:at + kp + ns - 1]
                            for si in range(ns):
                                wp = ws + ci * cp + (ti * ns + si) * chunk * cp
                                acc += xr[si:si + kp, None] * smem[wp:wp + 4]
            size = nq * npos * cp
            y_at = slices * size if slices > 1 else 0
            y2_at = y_at + size

            def yrow(row):
                return row ^ (row >> 3 & 7) if nq == 4 and kp == 8 else row

            for sl, u, g, qd, acc in roles:
                for i in range(kp):
                    at = yrow(u * npos + g * kp + i) * cp + 4 * qd
                    if slices == 1:
                        smem[y_at + at:y_at + at + 4] = acc[i]
                        smem[y2_at + at:y2_at + at + 4] = acc[i] ** 2
                    else:
                        smem[sl * size + at:sl * size + at + 4] = acc[i]
            if slices > 1:
                for e in range(nq * npos * cq):
                    row, o = yrow(e // cq), 4 * (e % cq)
                    v = np.array([bias[o + j] if o + j < cout else 0.0
                                  for j in range(4)])
                    for r in range(slices):
                        at = r * size + row * cp + o
                        v = v + smem[at:at + 4]
                    smem[y_at + row * cp + o:y_at + row * cp + o + 4] = v
                    smem[y2_at + row * cp + o:y2_at + row * cp + o + 4] = \
                        v ** 2
            for e in range(4 * npos if nq == 4 else 0):  # by pixel
                py, px = divmod(e, 2 * tb)
                ia, ib = a0 + (py >> 1), b0 + (px >> 1)
                if ia >= h or ib >= wd:
                    continue
                at = yrow(((py & 1) * 2 + (px & 1)) * npos
                          + (py >> 1) * tb + (px >> 1)) * 4
                for o in range(cout):
                    v = smem[y_at + at + o]
                    if mode:
                        norm = smem[b_at + o] + sum(
                            smem[g_at + j * 4 + o] * smem[y2_at + at + j]
                            for j in range(cout))
                        v = (v * np.sqrt(norm) if mode == "igdn"
                             else v / np.sqrt(norm))
                    out[n, 2 * a0 + py, 2 * b0 + px, o] = v
                    stores[n, 2 * a0 + py, 2 * b0 + px, o] += 1
            for e in range(nq * base if nq == 1 else 0):
                eu, rem = divmod(e, base)
                eg, o = rem // cq, 4 * (rem % cq)
                dh, dw = pl[eu][:2]
                row, col0 = eg * kp // tb, eg * kp % tb
                for i in range(kp):
                    at = (eu * npos + row * tb + col0 + i) * cp
                    ia, ib = a0 + row, b0 + col0 + i
                    if ia >= h or ib >= wd:
                        continue
                    for j in range(4):
                        if o + j >= cout:
                            break
                        v = smem[y_at + at + o + j]
                        if mode:
                            norm = smem[b_at + o + j] + sum(
                                smem[g_at + jj * cp + o + j]
                                * smem[y2_at + at + jj] for jj in range(cout))
                            v = (v * np.sqrt(norm) if mode == "igdn"
                                 else v / np.sqrt(norm))
                        out[n, 2 * ia + dh, 2 * ib + dw, o + j] = v
                        stores[n, 2 * ia + dh, 2 * ib + dw, o + j] += 1
    return out, stores


@pytest.mark.parametrize("shape,cout,tile", [
    ((1, 3, 5, 6), 5, (2, 4)),      # ragged tiles, Cout not a multiple of 4
    ((1, 1, 1, 40), 3, (1, 1)),     # a 1x1 input: one tap, 4 Cin slices
    ((2, 2, 2, 10), 10, (2, 2)),    # shared4's 2x2 stage, 2 slices
    ((1, 5, 7, 9), 8, (8, 16)),     # a tile taller and wider than the input
    ((1, 4, 4, 70), 4, (4, 4)),     # Cin in 3 chunks, 16-byte copies
    ((1, 6, 5, 3), 1, (4, 4)),      # Cout 1
    ((1, 8, 9, 2), 3, (8, 8))])     # four planes, 8 positions a thread
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_tiled_kernel_as_emulated_matches_plain(shape, cout, tile, mode):
    """The tiled kernel's indexing, emulated (`_emulate_tiled`), computes
    the plain version's output in float64 and stores every output value
    once."""
    x, w, b, gamma, beta = _deconv_case(shape, cout, seed=cout)
    if shape == (1, 4, 4, 70):
        assert tiled_config(1, 4, 4, 70, cout, *tile).chunk < 70 // 2
    got, stores = _emulate_tiled(x.astype(np.float64), w.astype(np.float64),
                                 b.astype(np.float64),
                                 gamma.astype(np.float64),
                                 beta.astype(np.float64), mode, *tile)
    want = deconv_igdn_plain(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(),
        torch.from_numpy(b).double(), torch.from_numpy(gamma).double(),
        torch.from_numpy(beta).double(), mode).numpy()
    assert (stores == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("h,w,t", [(1, 1, 1), (2, 2, 2), (3, 5, 2),
                                   (16, 16, 8), (17, 17, 4), (5, 7, 16)])
def test_parity_taps_are_the_taps_that_reach_the_image(h, w, t):
    """For each tile start and parity: the taps whose input offset reaches
    an in-image input from some in-image position of the tile, and the
    most of them over the launch (`max_parity_taps`, the stage's rows)."""
    for n in (h, w):
        for p0 in range(0, n, t):
            positions = range(p0, min(p0 + t, n))
            for d in (0, 1):
                want = [tt for tt in range(3 - d)
                        if any(0 <= p + tt + d - 1 < n for p in positions)]
                t_lo, count = parity_taps(d, p0, t, n)
                assert list(range(t_lo, t_lo + count)) == want
    assert deconv_mod.max_parity_taps(1, 1, 0) == 1
    assert deconv_mod.max_parity_taps(1, 1, 1) == 1
    assert deconv_mod.max_parity_taps(16, 8, 0) == 3
    assert deconv_mod.max_parity_taps(16, 8, 1) == 2


@pytest.mark.parametrize("shape,plan,config", [
    ((8, 16, 16, 42, 21), ("tiled", 4, 8, 1), (4, 4, 32, 9, 192)),
    ((8, 32, 32, 21, 21), ("tiled", 8, 16, 1), (8, 2, 21, 9, 192)),
    ((8, 1, 1, 120, 10), ("tiled", 1, 1, 1), (1, 16, 32, 1, 64)),
    ((8, 2, 2, 10, 10), ("tiled", 2, 2, 1), (1, 2, 10, 9, 32)),
    ((8, 4, 4, 10, 10), ("tiled", 2, 4, 1), (1, 2, 10, 9, 64)),
    ((8, 128, 128, 17, 17), ("tiled", 16, 16, 1), (8, 1, 17, 9, 160)),
    ((8, 64, 64, 21, 1), ("tiled", 8, 16, 1), (8, 4, 21, 25, 256)),
    ((8, 16, 16, 100, 50), ("tiled", 4, 8, 1), (8, 4, 16, 9, 224))])
def test_tiled_plan_of_shared4_and_rgb_stages(shape, plan, config):
    """shared4's decoder stages at batch 8 (and rgb's 16x16 -> 50): 4x8
    tiles (256 blocks) at 16x16; Cin slices while a launch has fewer
    threads than 32 warps an SM; the 1x1 input reading one tap; at Cout 1
    a block's four planes reading all 25 taps."""
    assert launch_plan(*shape) == plan
    assert tiled_config(*shape, *plan[1:3])[:5] == config


# --- launch plan of the GDN kernel ----------------------------------------

# (rows, C) of every GDN launch of one compress + decompress of a batch of 8
# at 256 px, and the plan each gets
_GDN_PATH_PLANS = [
    ((524288, 50), GDNPlan(8, 256, 56, 132, 3)),
    ((131072, 100), GDNPlan(8, 128, 112, 132, 2)),
    ((32768, 100), GDNPlan(8, 128, 112, 132, 2)),
    ((8192, 100), GDNPlan(2, 64, 56, 128, 2)),
    ((2048, 100), GDNPlan(2, 32, 56, 64, 2)),
    ((512, 100), GDNPlan(2, 32, 56, 16, 2)),
    ((128, 100), GDNPlan(2, 32, 56, 4, 2)),
    ((32, 100), GDNPlan(2, 32, 56, 1, 2)),
    ((8, 100), GDNPlan(2, 32, 56, 1, 2)),
    ((8192, 50), GDNPlan(2, 64, 56, 128, 2)),
    ((32768, 50), GDNPlan(8, 256, 56, 128, 2))]


@pytest.mark.parametrize("shape,plan", _GDN_PATH_PLANS)
def test_gdn_plan_of_the_path_shapes(shape, plan):
    """Persistent 8-row-per-thread blocks where the tiles fill half the
    SMs, else 2 rows per thread and 56-channel slices (C = 100 in two):
    the plans chip_smoke.py times on the H100."""
    assert gdn_plan(*shape) == plan
    check_plan(shape[1], plan)


_GDN_SHAPES = [(n, c) for n in (1, 5, 8, 31, 4099, 524288)
               for c in (1, 3, 50, 100, 127, 128)]


@pytest.mark.parametrize("variant", [None, "rows", "split"])
@pytest.mark.parametrize("n,c", _GDN_SHAPES)
def test_gdn_plan_fits_the_card(n, c, variant):
    """Every plan has a kernel (check_plan), at most 256 threads and the
    shared memory a block may have, and no more blocks than are resident
    on the H100's SMs at once."""
    plan = gdn_plan(n, c, variant)
    check_plan(c, plan)
    assert 32 <= threads(plan) <= MAX_THREADS
    assert gdn_smem_bytes(c, plan) <= MAX_SMEM
    slices = len(out_slices(c, plan.slice))
    assert plan.blocks * slices <= SMS * resident_per_sm(c, plan)
    assert plan.blocks <= -(-n // plan.tile_rows)
    assert gdn_plan(n, c, variant) is plan  # cached: one lookup a launch


@pytest.mark.parametrize("c", [1, 3, 28, 50, 56, 100, 128])
@pytest.mark.parametrize("slice_", [28, 56, 84, 112, 140])
def test_gdn_out_slices_cover_every_channel_once(c, slice_):
    slices = out_slices(c, slice_)
    covered = [o for start, size in slices for o in range(start, start + size)]
    assert covered == list(range(c))
    assert all(0 < size <= slice_ for _, size in slices)
    assert len(slices) == -(-c // slice_)


def test_gdn_plan_splits_small_row_counts_and_not_large_ones():
    for n in (8, 512, 8192):
        plan = gdn_plan(n, 100)
        assert plan.rm == 2 and len(out_slices(100, plan.slice)) == 2
    for n in (32768, 524288):
        plan = gdn_plan(n, 100)
        assert plan.rm == 8 and out_slices(100, plan.slice) == [(0, 100)]


@pytest.mark.parametrize("plan", [
    GDNPlan(3, 128, 112, 1, 2), GDNPlan(8, 100, 112, 1, 2),
    GDNPlan(8, 128, 100, 1, 2), GDNPlan(8, 128, 112, 0, 2),
    GDNPlan(8, 128, 112, 1, 5), GDNPlan(8, 256, 112, 1, 2),
    GDNPlan(2, 8, 28, 1, 2), GDNPlan(8, 128, 112, 132, 4)])
def test_gdn_check_plan_refuses_plans_without_a_kernel(plan):
    """Rows per thread other than 2 or 8, tiles or slices off the warp's
    grid, no blocks, 5 stages, 512 threads, too much shared memory."""
    with pytest.raises(ValueError):
        check_plan(100, plan)


def test_gdn_plan_refuses_an_unknown_variant():
    with pytest.raises(ValueError):
        gdn_plan(64, 100, "tiles")


# --- wide channels: GDN at C > 128, deconv+IGDN at Cout > 230 -------------

# rows of every GDN launch of one round trip of a batch of 8 at 256 px
_PATH_ROWS = [8 * 256 ** 2 >> 2 * s for s in range(9)] + [8 * 32 ** 2,
                                                          8 * 64 ** 2]


@pytest.mark.parametrize("c", [141, 150, 168, 192, 300, 400, 600])
@pytest.mark.parametrize("n", _PATH_ROWS)
def test_gdn_plan_fits_wide_channels(n, c):
    """Above 140 channels no all-channel block fits in shared memory, so
    every row count takes 28- or 56-channel slices of the output, with all
    C input channels per block (two launches stay bitwise equal)."""
    plan = gdn_plan(n, c)
    check_plan(c, plan)
    assert plan.rm == 2 and plan.slice in (28, 56)
    assert gdn_smem_bytes(c, plan) <= MAX_SMEM
    assert resident_per_sm(c, plan) >= 1
    assert plan.blocks * len(out_slices(c, plan.slice)) <= \
        SMS * resident_per_sm(c, plan)


@pytest.mark.parametrize("c,tile_rows,smem", [(192, 32, 136288),
                                              (300, 32, 211424)])
def test_gdn_wide_split_blocks_take_the_shared_memory_counted(c, tile_rows,
                                                              smem):
    """56-channel slices with 32-row tiles and 2 stages, by
    csrc/gdn.cu:smem_floats."""
    assert gdn_smem_bytes(c, GDNPlan(2, tile_rows, 56, 1, 2)) == smem
    assert gdn_plan(8, 300) == GDNPlan(2, 32, 56, 1, 2)


def test_gdn_max_channels_is_the_widest_c_a_plan_fits():
    check_plan(MAX_CHANNELS, gdn_plan(4099, MAX_CHANNELS))
    with pytest.raises(ValueError):
        check_plan(MAX_CHANNELS + 1, gdn_plan(4099, MAX_CHANNELS + 1))


# deconv+IGDN launches of decode at conv 300 and at conv 192 (latent 128,
# batch 8): g_s, then the decoder head at half width; then the widest
# tiles the card tests launch (4x4 at 570 channels, 1x4 at 1024)
_WIDE_DECONVS = [(8, 1, 1, 128, 300), (8, 2, 2, 300, 300),
                 (8, 4, 4, 300, 300), (8, 16, 16, 300, 150),
                 (8, 32, 32, 150, 150), (8, 64, 64, 150, 3),
                 (8, 1, 1, 128, 192), (8, 2, 2, 192, 192),
                 (8, 4, 4, 192, 192), (8, 16, 16, 192, 96),
                 (64, 4, 4, 192, 192), (9, 16, 16, 570, 570),
                 (8, 4, 4, 1024, 1024)]


@pytest.mark.parametrize("shape", _WIDE_DECONVS)
def test_deconv_launch_plan_fits_wide_cout(shape):
    """Where no tiled plan fits gamma and the weight stages in shared
    memory beside any tile ("tiled_l2": Cout 300 and wider) gamma stays in
    global memory; either way the block's shared memory fits."""
    b, h, w, cin, cout = shape
    variant, ta, tb, splits = launch_plan(*shape)
    assert splits == 1
    tile = tile_shape(b, h, w, cin, cout)
    assert variant == ("tiled" if tile else "tiled_l2")
    if tile:
        assert (ta, tb) == tile
        assert tiled_config(b, h, w, cin, cout, ta, tb).smem_bytes <= \
            deconv_mod.MAX_SMEM
    else:
        assert (ta, tb) == deconv_mod.wide_tiles(b, h, w)
        assert l2_smem_bytes(ta, tb, cin, cout) <= deconv_mod.MAX_SMEM
    if cout >= 300:
        assert variant == "tiled_l2"


def test_deconv_tiled_smem_at_the_widest_tile():
    """A 4x4 tile with Cin = Cout = 192 (64 images: 256 blocks) and gamma
    in shared memory: two weight stages of 4 channels, 231,168 bytes of the
    231,424 a block may have; at Cout = 300 gamma alone (360 KB) does not
    fit, and the kernel with gamma in L2 holds the tile, y and beta."""
    config = tiled_config(64, 4, 4, 192, 192, 4, 4)
    assert tile_shape(64, 4, 4, 192, 192) == (4, 4)
    assert config.chunk == 4 and config.smem_bytes == 231168
    assert tiled_smem_bytes(4, 4, 192, 192, 9, 1, 4) == 231168 <= \
        deconv_mod.MAX_SMEM
    assert tiled_config(8, 1, 1, 300, 300, 1, 1) is None
    assert l2_smem_bytes(1, 1, 300, 300, mode=None) == \
        4 * (9 * 300 + 4 * 300)
