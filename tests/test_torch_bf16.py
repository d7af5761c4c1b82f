"""The bf16 activation path of mmnc_tpu_torch (`build_model(...,
dtype=torch.bfloat16)`) against mmnc_tpu's `dtype=jnp.bfloat16` on the
CPU, at tests/test_bf16.py's widths (c=4, m=8, 256 px).

* tests/test_bf16.py's two checks on the port: parameters float32, x_hats
  bf16, likelihoods float32 and > 0, the loss float32 and finite; a
  model-1 train step whose loss falls over 6 steps.
* The bf16 GDN layer against JAX's `GDN(dtype=bf16)` (its XLA chain)
  within one bf16 ulp, 2^-8 x max(1, |ref|); `gdn_plain` in bf16 against
  `gdn_pallas` in interpret mode on bf16 within 2^-7 (the Pallas kernel
  rounds once, the chain at four points).
* `deconv_igdn_plain` in bf16 against JAX's Deconv + GDN chain in bf16
  and against `deconv_igdn_pallas` in interpret mode within 2^-7.
* `build_indexes` on the same bf16 scales equals JAX's exactly.
* Whole models 1 (rgb) and 2 (rgb, mono) from the port's seed-0 weights
  (conv kernels scaled, GDN parameters perturbed) carried to JAX by its
  importer: the eval forward's x_hats and y, and the training loss on the
  same bf16 noise (JAX's `quantize_noise` patched to add it in x's
  dtype). The port's distance from JAX bf16 is at most a quarter of JAX
  bf16's distance from JAX float32 (RMS distances; for the loss the
  absolute difference), which a float32 port would fail. The count of
  y symbols that differ between the port and JAX is printed, not
  asserted.
* The eval step's metrics on bf16 x_hats (PSNR and MS-SSIM on x255
  values, semantic mIoU on argmaxed logits) and losses, model 2 on rgb
  and semantic, within rtol 1e-3 of JAX's bf16 eval losses and of its
  metric functions on the upcast values (its own eval step raises on
  bf16 x_hats in MS-SSIM).
* Self-consistency in bf16: stream bytes equal `compress`'s, and
  `decompress`'s x_hats equal the eval forward's bitwise.

Torch runs 2 threads a test process (`two_threads`), as the tests share
the host's cores with other test processes.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.entropy import entropy_bottleneck as j_eb
from mmnc_tpu.entropy import gaussian_conditional as j_gc
from mmnc_tpu.entropy.gaussian_conditional import GaussianConditional
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.models.codecs import MultiTaskCodecNet
from mmnc_tpu.ops import layers as jl
from mmnc_tpu.ops.deconv_igdn_pallas import deconv_igdn_pallas
from mmnc_tpu.ops.gdn_pallas import gdn_pallas
from mmnc_tpu.train import make_eval_step as j_make_eval_step
from mmnc_tpu.utils.torch_import import import_reference_state_dict

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.entropy import gaussian_conditional as gc
from mmnc_tpu_torch.models.streaming import stream_roundtrip
from mmnc_tpu_torch.ops import layers as tl
from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn
from mmnc_tpu_torch.ops.gdn import GDNFunction, gdn
from mmnc_tpu_torch.ops.quant import quantize_noise, uniform_noise
from mmnc_tpu_torch.train import (create_train_state, make_eval_step,
                                  make_train_step)
from mmnc_tpu_torch.weights import scale_conv_kernels

BF16 = torch.bfloat16
ULP = 2.0 ** -8  # one bf16 ulp at 1 (8 significant bits)


@pytest.fixture(autouse=True)
def two_threads():
    """Torch on 2 threads: the tests share the host's cores with other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _within(got, want, tol):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _rms(a, b):
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


# --- tests/test_bf16.py on the port -----------------------------------------

def test_bf16_forward_and_loss_finite():
    m = build_model(2, ["rgb", "mono"], latent_channels=8, conv_channels=4,
                    lmbda=1e-2, device="cpu", dtype=BF16)
    batch = m.example_batch(batch_size=1, image_size=256)
    # params stay float32 (master weights); activations run bf16
    assert m.model.compressor.g_a[0].weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.parameters())
    noise = m.draw_noise(batch, torch.Generator().manual_seed(1))
    assert all(v.dtype == BF16 for v in noise.values())
    x_hats, lik = m(batch, training=True, noise=noise)
    assert x_hats["rgb"].dtype == BF16
    # entropy math upcasts: likelihoods come out float32 and positive
    assert lik["y"].dtype == torch.float32 and lik["z"].dtype == torch.float32
    assert bool((lik["y"] > 0).all())

    loss, _ = m.loss_and_logs(batch, True, m.draw_noise(
        batch, torch.Generator().manual_seed(2)))
    assert loss.dtype == torch.float32
    assert bool(torch.isfinite(loss))


def test_bf16_train_step_decreases_loss():
    m = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                    lmbda=1e-2, learning_rate_main=1e-3, device="cpu",
                    dtype=BF16)
    batch = m.example_batch(batch_size=2, image_size=256)
    state = create_train_state(m, 20, learning_rate_main=1e-3)
    step = make_train_step(m, compute_metrics=False)
    losses = []
    for _ in range(6):
        state, logs = step(state, batch, torch.Generator().manual_seed(1))
        losses.append(float(logs["train/loss"]))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.parameters() if p.grad is not None)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_bf16_codec_options():
    m = build_model(1, ["rgb"], 8, 4, device="cpu", dtype=BF16)
    assert "dtype" not in m.hyper_parameters  # a rebuilt checkpoint is f32
    assert m.corrected_geometry_twin().dtype == BF16
    with pytest.raises(ValueError, match="dtype"):
        build_model(1, ["rgb"], 8, 4, device="cpu", dtype=torch.float16)


def test_noise_is_drawn_and_added_in_the_activations_dtype():
    gen = torch.Generator().manual_seed(0)
    noise = uniform_noise((64, 8), gen, dtype=BF16)
    assert noise.dtype == BF16
    assert float(noise.min()) >= -0.5 and float(noise.max()) <= 0.5
    x = torch.randn(64, 8).to(BF16)
    # a float32 noise does not promote the bf16 sum (JAX draws it in bf16)
    got = quantize_noise(x, noise.float())
    assert got.dtype == BF16 and torch.equal(got, x + noise)


# --- the kernels' plain versions --------------------------------------------

@pytest.fixture(scope="module")
def gdn_data():
    rng = np.random.default_rng(0)
    c = 20
    x = rng.normal(size=(2, 8, 16, c)).astype(np.float32)
    beta_r = (1 + 0.2 * rng.random(c)).astype(np.float32)
    gamma_r = (0.3 * np.eye(c) + 0.05 * rng.random((c, c))).astype(np.float32)
    return x, gamma_r, beta_r


@pytest.mark.parametrize("inverse", [False, True])
def test_bf16_gdn_layer_matches_jax_within_one_ulp(gdn_data, inverse):
    x, gamma_r, beta_r = gdn_data
    params = {"beta": jnp.asarray(beta_r), "gamma": jnp.asarray(gamma_r)}
    want = jl.GDN(inverse=inverse, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x))
    layer = tl.GDN(x.shape[-1], inverse=inverse, dtype=BF16)
    with torch.no_grad():
        layer.beta.copy_(_t(beta_r))
        layer.gamma.copy_(_t(gamma_r))
        got = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within(got, want, ULP)


@pytest.mark.parametrize("inverse", [False, True])
def test_bf16_gdn_plain_matches_pallas_interpret(gdn_data, inverse):
    x, gamma_r, beta_r = gdn_data
    gamma, beta = gamma_r ** 2, beta_r  # any non-negative values
    xb = jnp.asarray(x, jnp.bfloat16)
    want = gdn_pallas(xb, jnp.asarray(gamma, jnp.bfloat16),
                      jnp.asarray(beta, jnp.bfloat16), inverse=inverse,
                      interpret=True)
    got = gdn(_t(x).to(BF16), _t(gamma), _t(beta), inverse)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within(got, want, 2 * ULP)


@pytest.mark.parametrize("inverse", [False, True])
def test_bf16_gdn_backward_computes_in_float32(gdn_data, inverse):
    """dx comes back bf16, dgamma and dbeta float32, and each equals the
    float32 closed form on the same (bf16-valued) inputs."""
    x, gamma_r, beta_r = gdn_data
    x2d = _t(x).reshape(-1, x.shape[-1]).to(BF16)
    gamma, beta = _t(gamma_r ** 2), _t(beta_r)
    g = torch.randn(x2d.shape, generator=torch.Generator().manual_seed(3))

    def grads(xx, gg):
        args = [a.clone().requires_grad_(True) for a in (xx, gamma, beta)]
        GDNFunction.apply(*args, inverse).backward(gg)
        return [a.grad for a in args]

    dx, dgamma, dbeta = grads(x2d, g.to(BF16))
    wx, wgamma, wbeta = grads(x2d.float(), g.to(BF16).float())
    assert (dx.dtype, dgamma.dtype, dbeta.dtype) == (BF16, torch.float32,
                                                     torch.float32)
    assert torch.equal(dx, wx.to(BF16))
    assert torch.equal(dgamma, wgamma) and torch.equal(dbeta, wbeta)


def _deconv_case(shape, cout, seed=0):
    """x ~ N(0, 1), the weight at the layers' init scale, bias 0.1 N(0, 1),
    gamma 0.1 I + 0.01 U(0, 1), beta 1 + 0.1 U(0, 1): chip_smoke.py's
    kernel cases. (test_torch_ops.py's cases, weights 0.2 N(0, 1) and
    gamma 0.1 U(0, 1), give IGDN norms of 10-100 and outputs up to 13;
    there the Pallas kernel, which does not round y before the epilogue,
    and the chain, which does and whose IGDN then squares that rounding,
    can differ by more than 2^-7 of the largest output.)"""
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = ((rng.random((5, 5, cin, cout)) * 2 - 1)
         / np.sqrt(25 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    gamma = (0.1 * np.eye(cout)
             + 0.01 * rng.random((cout, cout))).astype(np.float32)
    beta = (1.0 + 0.1 * rng.random((cout,))).astype(np.float32)
    return x, w, b, gamma, beta


@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 7, 5, 8)])
def test_bf16_deconv_igdn_plain_matches_jax_chain_and_pallas(mode, shape):
    x, w, b, gamma, beta = _deconv_case(shape, 8)
    bf = jnp.bfloat16
    xb = jnp.asarray(x, bf)
    # JAX's unfused chain: Deconv(dtype=bf16) casts x, w and b, then GDN's
    # XLA chain with gamma in bf16 and beta in float32
    y = jl.deconv(xb, jnp.asarray(w, bf)) + jnp.asarray(b, bf)
    if mode is not None:
        norm = jnp.einsum("bhwc,oc->bhwo", y * y, jnp.asarray(gamma, bf),
                          preferred_element_type=jnp.float32) + beta
        scale = jnp.sqrt(norm) if mode == "igdn" else jax.lax.rsqrt(norm)
        y = y * scale.astype(bf)
    pallas = deconv_igdn_pallas(
        xb, jnp.asarray(w, bf), jnp.asarray(b, bf),
        jnp.asarray(gamma, bf) if mode else None,
        jnp.asarray(beta, bf) if mode else None,
        mode=mode or "igdn", interpret=True)
    got = deconv_igdn(_t(x).to(BF16), _t(w), _t(b),
                      _t(gamma) if mode else None,
                      _t(beta) if mode else None, mode=mode)
    assert got.dtype == BF16 and y.dtype == pallas.dtype == bf
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 8)
    _within(got, y, 2 * ULP)
    _within(got, pallas, 2 * ULP)


def test_bf16_fused_layers_equal_unfused_on_cpu():
    """run_layers' no-grad fused deconv+IGDN path is, in bf16 as in
    float32, the same function as the layer-by-layer path."""
    from mmnc_tpu_torch.models.heads import DecoderHead

    head = DecoderHead(8, 3, dtype=BF16)
    head.apply(lambda m: m.init_parameters(torch.Generator().manual_seed(0))
               if hasattr(m, "init_parameters") else None)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        fused = head(x)
    unfused = x
    for layer in head:  # grad enabled: every layer on its own
        unfused = layer(unfused)
    assert fused.dtype == unfused.dtype == BF16
    assert torch.equal(fused, unfused.detach())


def test_bf16_weight_copies_follow_parameter_updates():
    """Under no-grad a layer reuses its bf16 weight copy until the
    parameter changes in place."""
    conv = tl.Conv(3, 4, dtype=BF16)
    conv.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        first = conv(x)
        again = conv(x)
        conv.weight.mul_(2.0)
        doubled = conv(x)
    assert torch.equal(first, again)
    want = torch.nn.functional.conv2d(  # float32 sums of bf16 values
        x.to(BF16).float(), conv.weight.detach().to(BF16).float(), None, 2,
        2).to(BF16)
    assert torch.equal(doubled, want + conv.bias.detach().to(BF16).view(
        -1, 1, 1))
    assert not torch.equal(doubled, first)


def test_bf16_build_indexes_equal_jax_exactly():
    """bucketize compares bf16 scales against the float32 table in float32,
    as JAX's `scales <= s` promotes; the lower bound rounds to bf16 in
    both."""
    rng = np.random.default_rng(7)
    scales = np.exp(rng.uniform(np.log(0.05), np.log(300.0), 4096))
    table = np.asarray(gc.get_scale_table())
    scales = np.concatenate([scales, table, np.nextafter(table, 0), [0.11]])
    sb = torch.from_numpy(scales.astype(np.float32)).to(BF16)
    got = gc.build_indexes(sb)
    want = GaussianConditional.build_indexes(
        jnp.asarray(scales.astype(np.float32), jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- whole models against JAX -----------------------------------------------

MODELS = {1: ["rgb"], 2: ["rgb", "mono"]}


def _port_model(number, dtype, state_dict=None):
    m = build_model(number, MODELS[number], latent_channels=8,
                    conv_channels=4, lmbda=1e-2, device="cpu", dtype=dtype)
    if state_dict is None:
        scale_conv_kernels(m)
        rng = np.random.default_rng(number)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith((".gamma", ".beta")):
                    p.add_(_t(0.02 * rng.normal(size=p.shape)))
    else:
        m.load_state_dict(state_dict)
    m.update_bottleneck_values()
    return m


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """The port's f32 and bf16 codec on the same weights, JAX's f32 and
    bf16 codec on them, a batch of 2 and bf16-valued noise (NHWC)."""
    number = request.param
    f32 = _port_model(number, torch.float32)
    bf16 = _port_model(number, BF16, f32.state_dict())
    jm = {dt: j_build_model(number, MODELS[number], latent_channels=8,
                            conv_channels=4, lmbda=1e-2, dtype=dt)
          for dt in (jnp.float32, jnp.bfloat16)}
    params = import_reference_state_dict(f32.state_dict(), jm[jnp.float32])
    batch = f32.example_batch(2, 256, seed=3)
    rng = np.random.default_rng(11)
    noise = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
             for k, s in f32.latent_shapes(batch).items()}
    noise = {k: _f32(_t(v).to(BF16)) for k, v in noise.items()}
    return {"number": number, "f32": f32, "bf16": bf16, "jm": jm,
            "params": params, "batch": batch, "noise": noise}


@pytest.fixture(scope="module")
def jax_runs(pair):
    """JAX's eval x_hats, y and training loss (on the pair's noise) in f32
    and bf16."""
    params, batch, noise = pair["params"], pair["batch"], pair["noise"]
    jb = {t: jnp.asarray(v) for t, v in batch.items()}

    def fixed(key):  # JAX draws the noise in x's dtype
        def add(x, rng):
            del rng
            return x + jnp.asarray(noise[key], x.dtype)
        return add

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed("z"))
        mp.setattr(j_gc, "quantize_noise", fixed("y"))
        for dt, jm in pair["jm"].items():
            @jax.jit
            def run(params, jm=jm):  # one program: eager flax is slow
                v = {"params": params}
                x_hats, _ = jm.forward(v, jb)
                y, _ = jm.net.apply(v, jb, method=MultiTaskCodecNet.analyze)
                loss, _ = jm.loss_and_logs(v, jb, jax.random.PRNGKey(0))
                return x_hats, y.astype(jnp.float32), loss

            x_hats, y, loss = jax.device_get(run(params))
            runs[dt] = {"x_hats": x_hats, "y": np.asarray(y),
                        "loss": float(loss)}
    return runs


def _port_run(model, batch, noise):
    x_hats, _ = model(batch)
    with torch.no_grad():
        y, _ = model.model.analyze(model._inputs(batch))
    loss, _ = model.loss_and_logs(batch, True, noise)
    return {"x_hats": x_hats, "y": y.permute(0, 2, 3, 1),
            "loss": float(loss.detach())}


def test_bf16_model_matches_jax_bf16_not_f32(pair, jax_runs):
    port = _port_run(pair["bf16"], pair["batch"], pair["noise"])
    f32 = _port_run(pair["f32"], pair["batch"], pair["noise"])
    jbf, jf = jax_runs[jnp.bfloat16], jax_runs[jnp.float32]
    for t in MODELS[pair["number"]]:
        assert port["x_hats"][t].dtype == BF16
        port_d = _rms(port["x_hats"][t], jbf["x_hats"][t])
        assert port_d <= 0.25 * _rms(jbf["x_hats"][t], jf["x_hats"][t]), t
        # discriminates: the float32 port is far from JAX bf16
        assert _rms(f32["x_hats"][t], jbf["x_hats"][t]) > 4 * port_d, t
    assert _rms(port["y"], jbf["y"]) <= 0.25 * _rms(jbf["y"], jf["y"])
    assert _rms(f32["y"], jbf["y"]) > 4 * _rms(port["y"], jbf["y"])
    jgap = abs(jbf["loss"] - jf["loss"])
    assert abs(port["loss"] - jbf["loss"]) <= 0.25 * jgap
    assert abs(f32["loss"] - jbf["loss"]) > 0.25 * jgap
    differ = int((np.round(_f32(port["y"])) != np.round(jbf["y"])).sum())
    print(f"model {pair['number']}: {differ} of {jbf['y'].size} y symbols "
          f"differ from JAX bf16's")


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_bf16_stream_and_decompress_are_self_consistent(pair, impl):
    model, batch = pair["bf16"], pair["batch"]
    ans, n_bytes = model.compress(batch)
    decoded = model.decompress(ans)
    x_hats, _ = model(batch)
    for t in model.tasks:
        assert decoded[t].dtype == BF16
        assert torch.equal(decoded[t], x_hats[t]), t
    (streamed, stream_bytes), = stream_roundtrip(model, [batch], impl=impl)
    assert stream_bytes == n_bytes
    for t in model.tasks:
        assert streamed[t].dtype == BF16
        assert torch.equal(streamed[t], decoded[t]), t


def test_bf16_eval_metrics_match_jax():
    """PSNR, MS-SSIM and mIoU of the bf16 x_hats and the eval losses,
    model 2 on rgb and semantic, against mmnc_tpu on the same weights.
    mmnc_tpu's eval step cannot give the metrics in bf16: its MS-SSIM
    convolves the bf16 x255 values with a float32 window and raises
    (mmnc_tpu/ops/metrics.py:59); the port computes every metric in
    float32. So the reference is mmnc_tpu's metric functions on its bf16
    eval x_hats, x255 in bf16 (as JAX's weakly typed scalar keeps it)
    and cast to float32, and its eval step's losses."""
    from mmnc_tpu.ops import metrics as JM

    tasks = ["rgb", "semantic"]
    model = build_model(2, tasks, latent_channels=8, conv_channels=4,
                        lmbda=1e-2, device="cpu", dtype=BF16)
    scale_conv_kernels(model)
    jmodel = j_build_model(2, tasks, latent_channels=8, conv_channels=4,
                           lmbda=1e-2, dtype=jnp.bfloat16)
    params = import_reference_state_dict(model.state_dict(), jmodel)
    batch = model.example_batch(2, 256, seed=5)
    jb = {t: jnp.asarray(v) for t, v in batch.items()}
    with pytest.raises(TypeError, match="same dtypes"):
        j_make_eval_step(jmodel)(params, jb)

    @jax.jit
    def reference(params):  # the eval step's losses, then the metrics
        _, (logs, x_hats, _) = jmodel.loss_and_logs(
            {"params": params}, jb, rng=None, training=False)
        logs = {k if "/" in k else f"val/{k}": v for k, v in logs.items()}
        for task in tasks:
            target = jb[task]
            if task == "semantic":
                pred = jnp.argmax(x_hats[task], axis=-1)[..., None].astype(
                    jnp.float32)
                mult, rng = 1.0, 17.0
                logs[f"val/{task}/miou"] = JM.miou(pred[..., 0],
                                                   target[..., 0])
            else:
                pred, mult, rng = x_hats[task], 255.0, 255.0
            scaled = (pred * mult).astype(jnp.float32)
            logs[f"val/{task}/psnr"] = JM.psnr(scaled, target * mult, rng)
            logs[f"val/{task}/ms-ssim"] = JM.ms_ssim(scaled, target * mult,
                                                     rng)
        return logs

    want = jax.device_get(reference(params))
    got = make_eval_step(model)(batch)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].item(), float(value), rtol=1e-3,
                                   err_msg=key)
