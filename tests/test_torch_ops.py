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
                                            deconv_weight_taps, launch_plan,
                                            tile_shape, tiled_smem_bytes)
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


@pytest.mark.parametrize("shape", [(8, 16, 16, 100, 50), (8, 32, 32, 50, 50),
                                   (8, 64, 64, 50, 3), (8, 128, 128, 3, 3)])
def test_launch_plan_keeps_the_tiles_of_the_wide_stages(shape):
    b, h, w, _, cout = shape
    assert launch_plan(*shape) == ("tiled", *tile_shape(b, h, w, cout), 1)


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
    """Where Cout x Cout of gamma does not fit beside the tile the plan
    leaves gamma in global memory ("tiled_l2"); either way the block's
    shared memory fits."""
    b, h, w, cin, cout = shape
    variant, ta, tb, splits = launch_plan(*shape)
    assert splits == 1 and (ta, tb) == tile_shape(b, h, w, cout)
    with_gamma = tiled_smem_bytes(ta, tb, cin, cout, gamma_l2=False)
    assert variant == ("tiled" if with_gamma <= deconv_mod.MAX_SMEM
                       else "tiled_l2")
    assert tiled_smem_bytes(ta, tb, cin, cout,
                            variant == "tiled_l2") <= deconv_mod.MAX_SMEM
    if cout == 300:
        assert variant == "tiled_l2"


def test_deconv_tiled_smem_at_the_widest_tile():
    """A 4x4 tile with Cin = Cout = 192 and gamma in shared memory: 225,024
    bytes of the 231,424 a block may have; at Cout = 300 gamma alone
    (360 KB) does not fit."""
    assert tiled_smem_bytes(4, 4, 192, 192, gamma_l2=False) == 225024
    assert tiled_smem_bytes(4, 4, 192, 192, gamma_l2=False) <= \
        deconv_mod.MAX_SMEM
    assert tiled_smem_bytes(1, 1, 300, 300, gamma_l2=False) > \
        deconv_mod.MAX_SMEM
    assert tiled_smem_bytes(1, 1, 300, 300, gamma_l2=True, mode=None) == \
        4 * (9 * 300 + 4 * 300)
