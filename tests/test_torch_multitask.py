"""The port's mixed, disjoint and shared codecs against mmnc_tpu on the CPU.

Three tasks of every width and both loss types (rgb 3 -> 3, depth 1 -> 1,
semantic 1 -> 17 logits, cross-entropy) at 256 px, batch 2: mixed m=8,
c=4; disjoint m=6, c=4; shared m=8, c=4 (two latent channels a block, an
upsample width of 4 // 3 = 1). JAX's init params, scaled and plus numpy
noise, are carried across by `state_dict_from_jax`.

Tolerances: floats as tests/test_torch_import.py (rtol 1e-3, atol 1e-4);
a training loss and its logs on the same injected noise within rtol 1e-4
(tests/test_torch_train.py); symbols, indexes and stream bytes exactly
equal (the bytes on JAX's EB table, see test_torch_entropy.py); the
port's decode equal to its own eval forward within atol 1e-5
(tests/test_models.py). One train step of the shared codec: every log
within rtol 1e-4 and each gradient within 1e-3 x max|g_jax| of its
tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnc_tpu.entropy import entropy_bottleneck as j_eb
from mmnc_tpu.entropy import gaussian_conditional as j_gc
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.train import create_train_state as j_create_train_state
from mmnc_tpu.train import make_train_step as j_make_train_step
from mmnc_tpu.utils.torch_import import import_reference_state_dict

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.entropy.tables import CdfTable
from mmnc_tpu_torch.train import create_train_state, make_train_step
from mmnc_tpu_torch.weights import state_dict_from_jax

TASKS = ("rgb", "depth_euclidean", "semantic")
# variant: (model number, latent channels, conv channels)
CONFIGS = {"mixed": (2, 8, 4), "disjoint": (3, 6, 4), "shared": (4, 8, 4)}
LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS = 1e-2, 1e-4, 1e-3, 10
BATCH = 2


def kernel_gain(path):
    """Conv kernels scaled as `weights.scale_conv_kernels` scales the
    port's (hyperprior 10, g_s and every output head 3, the rest 4), so y
    and z are not all near zero and the reconstruction is O(1)."""
    keys = [getattr(p, "key", None) for p in path]
    if keys[-1] != "kernel":
        return 1.0
    if "h_a" in keys or "h_s" in keys:
        return 10.0
    if "g_s" in keys or any(str(k).startswith(("output_heads_", "upsamples_"))
                            for k in keys):
        return 3.0
    return 4.0


def make_pair(variant):
    """(JAX codec, its scaled + noised params as {"params": ...}, the port
    codec carrying them, a batch: numpy NHWC, semantic labels 0..16)."""
    number, m, c = CONFIGS[variant]
    jmodel = j_build_model(number, TASKS, latent_channels=m, conv_channels=c,
                           lmbda=LMBDA)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * kernel_gain(path)
                         + 0.02 * rng.normal(size=v.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    port = build_model(number, TASKS, latent_channels=m, conv_channels=c,
                       lmbda=LMBDA, device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    return jmodel, {"params": params}, port, port.example_batch(BATCH, seed=1)


def jax_batch(batch):
    return {t: jnp.asarray(v) for t, v in batch.items()}


def use_jax_eb_table(port, j_tables):
    """The port's tables with JAX's EB table in place (the EB CDF can differ
    by one count, test_torch_entropy.py); the Gaussian table and the
    medians are checked equal. Returns the port's tables."""
    tables = port.update_bottleneck_values()
    np.testing.assert_array_equal(tables.gc.cdfs, j_tables.gc.cdfs)
    np.testing.assert_array_equal(tables.eb_medians, j_tables.eb_medians)
    tables.eb = CdfTable(cdfs=j_tables.eb.cdfs,
                         cdf_lengths=j_tables.eb.cdf_lengths,
                         offsets=j_tables.eb.offsets)
    return tables


@pytest.fixture(scope="module")
def pairs():
    """make_pair's results by variant, built once for the module."""
    return {}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, pairs):
    if request.param not in pairs:
        pairs[request.param] = make_pair(request.param)
    return pairs[request.param]


@pytest.fixture(scope="module")
def shared_pair(pairs):
    if "shared" not in pairs:
        pairs["shared"] = make_pair("shared")
    return pairs["shared"]


def _noise(port, batch, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for k, s in port.latent_shapes(batch).items()}


def _patch_noise(mp, noise):
    """quantize_noise in mmnc_tpu's entropy modules adds our noise (told
    apart by shape: y and z differ in channels in every config) instead of
    drawing it."""
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}
    assert len(by_shape) == 2

    def fixed(x, rng):
        del rng
        return x + by_shape[tuple(x.shape)]

    mp.setattr(j_eb, "quantize_noise", fixed)
    mp.setattr(j_gc, "quantize_noise", fixed)


def test_importer_recovers_jax_params_and_surface_matches(pair):
    """import_reference_state_dict reads the port's state_dict back to
    JAX's params exactly (disjoint/shared: the nested output heads; mixed:
    g_s; log_vars), and the constructor's surface equals JAX's."""
    jmodel, variables, port, _ = pair
    back = import_reference_state_dict(port.state_dict(), jmodel)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        variables["params"])[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path])
    assert port.hyper_parameters == jmodel.hyper_parameters
    assert port.variant_slices() == jmodel.variant_slices()
    assert (port.latent_channels, port.channels_per_task) == (
        jmodel.latent_channels, jmodel.channels_per_task)
    assert port.get_model_name() == jmodel.get_model_name()
    want = jmodel.example_batch(3, 64, seed=7)
    for task, x in port.example_batch(3, 64, seed=7).items():
        assert x.tobytes() == np.asarray(want[task]).tobytes()


def test_eval_forward_and_likelihoods_match_jax(pair):
    jmodel, variables, port, batch = pair
    j_hats, j_lik = jmodel.forward(variables, jax_batch(batch),
                                   training=False)
    t_hats, t_lik = port(batch)
    for task, oc in zip(TASKS, port.output_channels):
        assert t_hats[task].shape == (BATCH, 256, 256, oc)
        np.testing.assert_allclose(t_hats[task].numpy(),
                                   np.asarray(j_hats[task]),
                                   rtol=1e-3, atol=1e-4, err_msg=task)
    for key in ("y", "z"):
        assert t_lik[key].shape == j_lik[key].shape
        np.testing.assert_allclose(t_lik[key].numpy(), np.asarray(j_lik[key]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)


def test_training_loss_and_logs_match_jax(pair):
    """The training loss (uncertainty-weighted reconstruction with the
    noised log_vars, the variant's rate) and every log on the same
    injected noise, within rtol 1e-4."""
    jmodel, variables, port, batch = pair
    noise = _noise(port, batch, 2)
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        j_loss, (j_logs, _, _) = jmodel.loss_and_logs(
            variables, jax_batch(batch), rng=jax.random.PRNGKey(0),
            training=True)
    loss, (logs, _, _) = port.loss_and_logs(
        batch, training=True,
        noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert set(logs) == set(j_logs)
    assert any(k.startswith("uncertainty-weight/") for k in logs)
    for key, want in j_logs.items():
        np.testing.assert_allclose(logs[key].item(), float(want), rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)


def test_encode_eval_and_decode_from_latents_match_jax(pair):
    jmodel, variables, port, batch = pair
    j_y, j_z = jmodel.encode_eval(variables, jax_batch(batch))
    y_hat, z_hat = port.encode_eval(batch)
    np.testing.assert_array_equal(y_hat.numpy(), np.asarray(j_y))
    np.testing.assert_allclose(z_hat.numpy(), np.asarray(j_z),
                               rtol=1e-3, atol=1e-4)
    assert (y_hat != 0).any()
    j_out = jmodel.decode_from_latents(variables, j_y, j_z)
    out = port.decode_from_latents(y_hat, z_hat)
    for task in TASKS:
        np.testing.assert_allclose(out[task].numpy(), np.asarray(j_out[task]),
                                   rtol=1e-3, atol=1e-4, err_msg=task)


def test_twin_rate_matches_jax_and_shares_parameters(pair):
    """The corrected-geometry twin's likelihoods (y over its own 1x1
    support) and eval rate equal JAX's twin's, it is memoised, and it shares
    the codec's parameter tensors: an update to the codec shows in it."""
    jmodel, variables, port, batch = pair
    twin = port.corrected_geometry_twin()
    assert twin is port.corrected_geometry_twin()
    assert twin.corrected_geometry_twin() is twin
    assert not twin.legacy_broadcast and port.legacy_broadcast
    assert twin.hyper_parameters["legacy_broadcast"] is False
    jtwin = jmodel.corrected_geometry_twin()
    _, (j_logs, _, j_lik) = jtwin.loss_and_logs(variables, jax_batch(batch),
                                                training=False)
    _, (logs, _, lik) = twin.loss_and_logs(batch, training=False)
    assert lik["y"].shape == j_lik["y"].shape == (BATCH, 1, 1,
                                                 port.latent_channels)
    assert port(batch)[1]["y"].shape[1:3] == (4, 4)  # the legacy broadcast
    np.testing.assert_allclose(lik["y"].numpy(), np.asarray(j_lik["y"]),
                               rtol=1e-3, atol=1e-4)
    for key in [k for k in j_logs if "compression_loss" in k]:
        np.testing.assert_allclose(logs[key].item(), float(j_logs[key]),
                                   rtol=1e-4, err_msg=key)
    params = dict(port.named_parameters())
    twin_params = dict(twin.named_parameters())
    assert params.keys() == twin_params.keys()
    assert all(params[k] is twin_params[k] for k in params)
    weight = params["model.input_heads.0.0.weight"]
    before = twin(batch)[1]["z"]
    with torch.no_grad():
        weight.mul_(2.0)
    try:
        after = twin(batch)[1]["z"]
        assert not torch.equal(after, before)
        assert torch.equal(after, port.corrected_geometry_twin()(batch)[1]["z"])
    finally:
        with torch.no_grad():
            weight.mul_(0.5)
    assert torch.equal(twin(batch)[1]["z"], before)


def test_symbols_and_indexes_equal_to_jax(pair):
    jmodel, variables, port, batch = pair
    want = jax.device_get(jmodel._compress_device(variables,
                                                  jax_batch(batch)))
    got = [x.contiguous().numpy() for x in port._compress_device(batch)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    y_sym, z_sym, indexes = got
    assert (y_sym != 0).any() and (z_sym != 0).any()
    assert len(np.unique(indexes)) > 1


@pytest.mark.parametrize("packed", [True, False])
def test_stream_bytes_equal_to_jax_on_jax_tables(pair, packed):
    jmodel, variables, port, batch = pair
    j_tables = jmodel.update_bottleneck_values(variables)
    use_jax_eb_table(port, j_tables)
    j_ans, j_n = jmodel.compress(variables, j_tables, jax_batch(batch),
                                 packed=packed)
    ans, n = port.compress(batch, packed=packed)
    assert n == j_n
    assert ans == j_ans


@pytest.mark.parametrize("packed", [True, False])
def test_decompress_both_call_forms_match_jax(pair, packed):
    """decompress(ans) and decompress(strings, shape, y_shape, batch_size)
    give the same decode, equal to the port's eval forward (atol 1e-5) and
    to JAX's decompress of the same streams; in the reference's form
    without y_shape, y_shape is 4 x shape as in JAX."""
    jmodel, variables, port, batch = pair
    j_tables = jmodel.update_bottleneck_values(variables)
    use_jax_eb_table(port, j_tables)
    ans, _ = port.compress(batch, packed=packed)
    ref, _ = port(batch)
    by_dict = port.decompress(ans)
    by_args = port.decompress(ans["strings"], ans["shape"], ans["y_shape"],
                              batch_size=BATCH if packed else None)
    j_out = jmodel.decompress(variables, j_tables, ans["strings"],
                              ans["shape"], ans["y_shape"],
                              batch_size=BATCH if packed else None)
    for task in TASKS:
        np.testing.assert_array_equal(by_args[task].numpy(),
                                      by_dict[task].numpy())
        np.testing.assert_allclose(by_dict[task].numpy(), ref[task].numpy(),
                                   atol=1e-5, err_msg=task)
        np.testing.assert_allclose(by_dict[task].numpy(),
                                   np.asarray(j_out[task]), rtol=1e-3,
                                   atol=1e-4, err_msg=task)
    # the reference's default y_shape, 4 x shape (4 x 4 here, where y is
    # 1 x 1): both packages ask the stream for 16 x its symbols and the
    # coder stops at its end (code -2)
    for decode in (
            lambda: port.decompress(ans["strings"], ans["shape"],
                                    batch_size=BATCH if packed else None),
            lambda: jmodel.decompress(variables, j_tables, ans["strings"],
                                      ans["shape"],
                                      batch_size=BATCH if packed else None)):
        with pytest.raises(RuntimeError, match="code -2"):
            decode()


def test_train_step_of_shared_codec_matches_jax(shared_pair):
    """One make_train_step step of the shared codec (clip 5) from the same
    params on the same injected noise: every log within rtol 1e-4, each
    gradient (log_vars included) within 1e-3 x max|g_jax| of its tensor."""
    jmodel, variables, _, batch = shared_pair
    params = variables["params"]
    port = build_model(4, TASKS, latent_channels=CONFIGS["shared"][1],
                       conv_channels=CONFIGS["shared"][2], lmbda=LMBDA,
                       device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    noise = _noise(port, batch, 3)
    key = jax.random.PRNGKey(0)

    def j_loss(p):
        loss, _ = jmodel.loss_and_logs({"params": p}, jax_batch(batch),
                                       rng=key, training=True)
        return loss + jmodel.aux_loss({"params": p})

    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        j_grads = jax.device_get(jax.jit(jax.grad(j_loss))(params))
        state = j_create_train_state(params, TOTAL_STEPS, LR_MAIN, LR_AUX)
        step = j_make_train_step(jmodel, compute_metrics=True, donate=False,
                                 clip_norm=5.0)
        _, j_logs = step(state, jax_batch(batch), key)
        j_logs = jax.device_get(j_logs)
    state = create_train_state(port, TOTAL_STEPS, LR_MAIN, LR_AUX)
    _, logs = make_train_step(port, clip_norm=5.0)(
        state, batch, noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert set(logs) == set(j_logs)
    for name, want in j_logs.items():
        np.testing.assert_allclose(logs[name].item(), float(want), rtol=1e-4,
                                   err_msg=name)
    gnorm = float(j_logs["train/grad_norm"])
    scale = min(1.0, 5.0 / max(gnorm, 1e-12))
    want = state_dict_from_jax(j_grads)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(want) == set(grads)
    assert "loss_balancer.log_vars" in want
    for name, g in want.items():
        err = (grads[name] - g * scale).abs().max().item()
        assert err <= 1e-3 * (g * scale).abs().max().item(), (name, err)


@pytest.mark.parametrize("number", [2, 3, 4])
def test_chip_smoke_shape_lists_are_the_launches(number, monkeypatch):
    """chip_smoke.py checks and times the kernels at `mt_gdn_shapes` and
    `mt_deconv_shapes` and sums them over a round trip: they are the
    (I)GDN and deconv+IGDN launches, in order, of a compress ->
    decompress and of a train step's forward of the codec (here four
    tasks, latent 10, conv 8, one image), and their lengths are phase 8's
    launch counts at the paper's widths."""
    import chip_smoke
    from mmnc_tpu_torch.ops import gdn as gdn_mod
    from mmnc_tpu_torch.ops import layers

    tasks = TASKS + ("normal",)
    gdns, deconvs = [], []
    plain_gdn, plain_deconv = gdn_mod.gdn_rows, layers.deconv_igdn

    def gdn_rows(x2d, gamma, beta, inverse):
        gdns.append((x2d.shape[0], x2d.shape[1], inverse))
        return plain_gdn(x2d, gamma, beta, inverse)

    def deconv_igdn(x, w, b, gamma=None, beta=None, mode="igdn"):
        deconvs.append((*x.shape, w.shape[-1], mode))
        return plain_deconv(x, w, b, gamma, beta, mode)

    monkeypatch.setattr(gdn_mod, "gdn_rows", gdn_rows)
    monkeypatch.setattr(layers, "deconv_igdn", deconv_igdn)
    model = build_model(number, tasks, 10, 8, device="cpu")
    model.update_bottleneck_values()
    lay = chip_smoke.paper_layout(number, tasks, 10, 8)
    assert lay["latent"] == model.latent_channels
    batch = model.example_batch(1)
    model.decompress(model.compress(batch)[0])
    assert gdns == chip_smoke.mt_gdn_shapes(lay, 1)
    assert deconvs == chip_smoke.mt_deconv_shapes(lay, 1)
    gdns.clear()
    model.loss_and_logs(batch, training=True,
                        noise={k: torch.zeros(s) for k, s in
                               model.latent_shapes(batch).items()})
    assert gdns == chip_smoke.mt_gdn_shapes(lay, 1, train=True)

    for name, calls in chip_smoke.MT_LAUNCHES.items():
        lay = chip_smoke.paper_layout(*chip_smoke.PAPER[name])
        gdn, dec = (sum(calls[k][i] for k in ("compress", "decompress"))
                    for i in (0, 1))
        assert len(chip_smoke.mt_gdn_shapes(lay, 8)) == gdn
        assert len(chip_smoke.mt_deconv_shapes(lay, 8)) == dec
        if "train" in calls:
            assert len(chip_smoke.mt_gdn_shapes(lay, 2, train=True)) == \
                calls["train"][0]
