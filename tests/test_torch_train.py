"""The ported training slice against mmnc_tpu on the CPU: the single-task
rgb codec (c=4, m=8 at 256 px, batch 2) with JAX params carried over by
`state_dict_from_jax`, and the same numpy noise injected on both sides
(on the JAX side `quantize_noise` is replaced in the two entropy modules
before the step is traced; nothing in mmnc_tpu changes).

Two train steps of each package, with no clip and with a clip that
engages: every log within rtol 1e-4, every parameter's gradient within
1e-3 x max|g_jax| of that tensor, each step's parameter change equal to
JAX's within 1e-2 x lr of that group where the gradient stands well above
its rounding, and within 2.5 x lr elsewhere (a near-zero gradient may flip
the sign of Adam's update). The JAX runs are module-scoped fixtures."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from mmnc_tpu.entropy import entropy_bottleneck as j_eb
from mmnc_tpu.entropy import gaussian_conditional as j_gc
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.train import create_train_state as j_create_train_state
from mmnc_tpu.train import make_eval_step as j_make_eval_step
from mmnc_tpu.train import make_train_step as j_make_train_step

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.ops.gdn import gdn_cuda
from mmnc_tpu_torch.train import (create_train_state, make_eval_step,
                                  make_train_step, param_partition)
from mmnc_tpu_torch.train.state import cosine_lr
from mmnc_tpu_torch.weights import state_dict_from_jax

LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS = 1e-2, 1e-4, 1e-3, 10
CLIP = 1.0  # the gradient's norm at these params is in the hundreds
QUANTILES = "model.compressor.entropy_bottleneck.quantiles"


def _kernel_gain(path):
    """Conv kernels scaled (encoder 4, hyper 10, decoder 3) so y and z are
    not all near zero and the reconstruction is O(1), as in
    test_torch_codec.py."""
    keys = [getattr(p, "key", None) for p in path]
    if keys[-1] != "kernel":
        return 1.0
    if "h_a" in keys or "h_s" in keys:
        return 10.0
    if "g_s" in keys or "output_heads_0" in keys:
        return 3.0
    return 4.0


@pytest.fixture(scope="module")
def setup():
    """The JAX codec, its scaled params (plus numpy noise, so GDN and the
    EB are off their init values), a batch and the step's noise (NHWC)."""
    jmodel = j_build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * _kernel_gain(path)
                         + 0.02 * rng.normal(size=v.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    batch = {"rgb": rng.random((2, 256, 256, 3)).astype(np.float32)}
    noise = {"y": rng.uniform(-0.5, 0.5, (2, 1, 1, 8)).astype(np.float32),
             "z": rng.uniform(-0.5, 0.5, (2, 1, 1, 4)).astype(np.float32)}
    return jmodel, params, batch, noise


def _patched_noise(mp, noise):
    """quantize_noise in mmnc_tpu's entropy modules adds our noise (told
    apart by shape: y has 8 channels, z 4) instead of drawing it."""
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}

    def fixed(x, rng):
        del rng
        return x + by_shape[tuple(x.shape)]

    mp.setattr(j_eb, "quantize_noise", fixed)
    mp.setattr(j_gc, "quantize_noise", fixed)


def _j_loss(jmodel, params, batch, key):
    variables = {"params": params}
    loss, (logs, _, _) = jmodel.loss_and_logs(variables, batch, rng=key,
                                              training=True)
    return loss + jmodel.aux_loss(variables)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per clip (None, CLIP): the JAX gradients at the start of each of
    two steps, and each step's logs and params."""
    jmodel, params, batch, noise = setup
    key = jax.random.PRNGKey(0)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        _patched_noise(mp, noise)
        grad_fn = jax.jit(jax.grad(lambda p: _j_loss(jmodel, p, batch, key)))
        for clip in (None, CLIP):
            state = j_create_train_state(params, TOTAL_STEPS, LR_MAIN, LR_AUX)
            step = j_make_train_step(jmodel, compute_metrics=True,
                                     donate=False, clip_norm=clip)
            steps = []
            for _ in range(2):
                grads = jax.device_get(grad_fn(state.params))
                state, logs = step(state, batch, key)
                steps.append((grads, jax.device_get(logs),
                              jax.device_get(state.params)))
            runs[clip] = steps
        eval_logs = jax.device_get(j_make_eval_step(jmodel)(params, batch))
    return runs, eval_logs


def _port(params, **kwargs):
    model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, device="cpu", **kwargs)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _t_noise(noise):
    return {k: torch.from_numpy(v) for k, v in noise.items()}


def _port_steps(setup, clip, remat=False, steps=2):
    """The port's steps from the same params and noise: per step the
    (clipped) gradients left on the parameters, the logs and the params."""
    _, params, batch, noise = setup
    model = _port(params)
    state = create_train_state(model, TOTAL_STEPS, LR_MAIN, LR_AUX)
    step = make_train_step(model, compute_metrics=True, clip_norm=clip,
                           remat=remat)
    out = []
    for _ in range(steps):
        state, logs = step(state, batch, noise=_t_noise(noise))
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out.append((grads, {k: v.item() for k, v in logs.items()},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def port_runs(setup):
    return {clip: _port_steps(setup, clip) for clip in (None, CLIP)}


def _lr(name, k):
    """The lr of `name`'s group at step k (0-based, the pre-update count)."""
    if name.endswith("quantiles"):
        return LR_AUX
    return cosine_lr(k, TOTAL_STEPS, LR_MAIN, 1e-8)


@pytest.mark.parametrize("clip", [None, CLIP])
def test_two_train_steps_match_jax(setup, jax_runs, port_runs, clip):
    runs, _ = jax_runs
    j_before = t_before = state_dict_from_jax(setup[1])
    settled = None  # per tensor: |g_jax| well above rounding at every step
    for k, ((j_grads, j_logs, j_params), (t_grads, t_logs, t_params)) in \
            enumerate(zip(runs[clip], port_runs[clip])):
        # logs: the same keys, each within rtol 1e-4
        assert set(t_logs) == set(j_logs), (sorted(t_logs), sorted(j_logs))
        for key, want in j_logs.items():
            np.testing.assert_allclose(t_logs[key], float(want), rtol=1e-4,
                                       err_msg=f"step {k} {key}")
        # gradients: JAX's unclipped gradient times JAX's clip scale
        scale = 1.0
        if clip is not None:
            gnorm = float(j_logs["train/grad_norm"])
            assert gnorm > clip  # the clip engages
            scale = min(1.0, clip / max(gnorm, 1e-12))
        want = state_dict_from_jax(j_grads)
        assert set(want) == set(t_grads)
        for name, g in want.items():
            g = g * scale
            err = (t_grads[name] - g).abs().max().item()
            assert err <= 1e-3 * g.abs().max().item(), (k, name, err)
        # updates: each step's parameter change equals JAX's within 1e-2 x
        # lr where the clipped |g_jax| stood well above its rounding (the
        # 1e-3 x max|g| of the check above) and Adam's eps (1e-8) at every
        # step so far; elsewhere Adam's update of a near-zero gradient may
        # flip sign, so within 2.5 x lr
        settled = {name: (g.abs() * scale > max(0.05 * g.abs().max().item()
                                                * scale, 1e-6))
                   & (True if settled is None else settled[name])
                   for name, g in want.items()}
        j_after = state_dict_from_jax(j_params)
        for name, p in j_after.items():
            lr = _lr(name, k)
            j_delta = p - j_before[name]
            t_delta = t_params[name] - t_before[name]
            diff = (t_delta - j_delta).abs()
            assert diff.max().item() <= 2.5 * lr, (k, name)
            tight = torch.where(settled[name], diff, 0.0).max().item()
            assert tight <= 1e-2 * lr, (k, name, tight / lr)
            if k == 0:  # Adam's first update is lr x sign(g), so a missing
                # or sign-flipped update fails the check above
                assert (j_delta.abs()[settled[name]] > 0.9 * lr).all(), name
        # both groups moved in the port
        for group in ("main", "aux"):
            assert any(not torch.equal(t_params[n], t_before[n])
                       for n in j_after if (_lr(n, k) == LR_AUX)
                       == (group == "aux")), (k, group)
        assert sum(int(m.sum()) for m in settled.values()) > 0
        j_before, t_before = j_after, t_params


def test_eval_step_logs_match_jax(setup, jax_runs):
    _, params, batch, _ = setup
    _, want = jax_runs
    model = _port(params)
    got = make_eval_step(model)(batch)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].item(), float(value), rtol=1e-4,
                                   err_msg=key)


def test_main_loss_never_reaches_quantiles_and_aux_reaches_only_them(setup):
    """The two facts that make one backward over main + aux right: the
    training main loss's gradient on `quantiles` is exactly 0 (it never
    reaches them), and the aux loss's is non-zero on `quantiles` only."""
    _, params, batch, noise = setup
    model = _port(params)
    loss, _ = model.loss_and_logs(batch, training=True, noise=_t_noise(noise))
    loss.backward()
    quantiles = dict(model.named_parameters())[QUANTILES]
    assert quantiles.grad is None
    model.zero_grad(set_to_none=True)
    model.aux_loss().backward()
    for name, p in model.named_parameters():
        if name == QUANTILES:
            assert p.grad.abs().max().item() > 0
        else:
            assert p.grad is None or not p.grad.any(), name


def test_aux_loss_value_and_gradient_match_jax(setup):
    jmodel, params, _, _ = setup
    value, grads = jax.value_and_grad(
        lambda p: jmodel.aux_loss({"params": p}))(params)
    model = _port(params)
    aux = model.aux_loss()
    aux.backward()
    np.testing.assert_allclose(aux.item(), float(value), rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(grads))
    for name, p in model.named_parameters():
        if name == QUANTILES:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6)
        else:
            assert p.grad is None and not want[name].any(), name


def test_partition_and_quantiles_move_only_by_the_aux_gradient(setup):
    """`quantiles` is the one "aux" parameter; after a train step it equals
    what one Adam step at the aux lr on the aux loss alone gives."""
    _, params, batch, noise = setup
    model = _port(params)
    labels = param_partition(model)
    assert [n for n, v in labels.items() if v == "aux"] == [QUANTILES]
    assert len(labels) == len(list(model.parameters()))
    state = create_train_state(model, TOTAL_STEPS, LR_MAIN, LR_AUX)
    assert [g["name"] for g in state.optimizer.param_groups] == ["main", "aux"]

    alone = _port(params)
    q = dict(alone.named_parameters())[QUANTILES]
    adam = torch.optim.Adam([q], lr=LR_AUX)
    alone.aux_loss().backward()
    adam.step()

    make_train_step(model, compute_metrics=False)(state, batch,
                                                  noise=_t_noise(noise))
    got = dict(model.named_parameters())[QUANTILES]
    assert not torch.equal(got, torch.from_numpy(
        params["compressor"]["entropy_bottleneck"]["quantiles"]))
    torch.testing.assert_close(got, q, rtol=1e-6, atol=1e-7)


def test_remat_step_equals_plain_step(setup):
    """torch.utils.checkpoint (non-reentrant) recomputes the same unfused
    forward with the same noise: two clipped steps give the plain steps'
    losses and parameters within 1e-6."""
    plain = _port_steps(setup, 5.0)
    remat = _port_steps(setup, 5.0, remat=True)
    for (_, p_logs, p_params), (_, r_logs, r_params) in zip(plain, remat):
        np.testing.assert_allclose(r_logs["train/loss"], p_logs["train/loss"],
                                   rtol=1e-6)
        for name, p in p_params.items():
            torch.testing.assert_close(r_params[name], p, rtol=1e-6,
                                       atol=1e-7)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(LR_MAIN, TOTAL_STEPS,
                                        alpha=1e-8 / LR_MAIN)
    for k in (0, TOTAL_STEPS // 2, TOTAL_STEPS, 2 * TOTAL_STEPS):
        np.testing.assert_allclose(cosine_lr(k, TOTAL_STEPS, LR_MAIN, 1e-8),
                                   float(sched(k)), rtol=1e-6)


def test_state_sets_the_scheduled_lr_before_each_update(setup):
    _, params, batch, noise = setup
    model = _port(params)
    state = create_train_state(model, 4, LR_MAIN, LR_AUX)
    step = make_train_step(model, compute_metrics=False)
    for k in range(6):
        step(state, batch, noise=_t_noise(noise))
        main, aux = state.optimizer.param_groups
        assert main["lr"] == cosine_lr(k, 4, LR_MAIN, 1e-8)
        assert aux["lr"] == LR_AUX
    assert state.step == 6


def test_state_defaults_to_the_models_rates(setup):
    """create_train_state without rates trains at the model's
    learning_rate_main / learning_rate_aux (the JAX class's defaults
    unless the model is built with others), as the reference's loop
    passes them."""
    model = _port(setup[1], learning_rate_main=3e-4, learning_rate_aux=2e-3)
    main, aux = create_train_state(model, TOTAL_STEPS).optimizer.param_groups
    assert (main["lr"], aux["lr"]) == (3e-4, 2e-3)
    main, aux = create_train_state(_port(setup[1]), TOTAL_STEPS,
                                   LR_MAIN).optimizer.param_groups
    assert (main["lr"], aux["lr"]) == (LR_MAIN, 1e-3)
    assert _port(setup[1]).learning_rate_main == 1e-5


def test_noise_shapes_generator_and_launches_on_the_cpu(setup):
    """latent_shapes gives the forward's y and z; the step draws its noise
    from the generator (same seed, same step); the CPU path launches no
    kernel; a training forward without noise raises."""
    _, params, batch, _ = setup
    model = _port(params)
    shapes = model.latent_shapes(batch)
    assert shapes == {"y": (2, 1, 1, 8), "z": (2, 1, 1, 4)}
    with pytest.raises(ValueError):
        model(batch, training=True)
    x_hats, liks = model(batch, training=True,
                         noise=model.draw_noise(batch,
                                                torch.Generator().manual_seed(0)))
    assert x_hats["rgb"].requires_grad
    assert liks["z"].shape == shapes["z"]
    assert liks["y"].shape == (2, 4, 4, 8)  # y broadcast against 4x4 scales

    losses = []
    for _ in range(2):
        m = _port(params)
        state = create_train_state(m, TOTAL_STEPS, LR_MAIN, LR_AUX)
        step = make_train_step(m, compute_metrics=False)
        before = gdn_cuda.launches
        _, logs = step(state, batch, torch.Generator().manual_seed(7))
        assert gdn_cuda.launches == before
        losses.append(logs["train/loss"].item())
        with pytest.raises(ValueError):
            step(state, batch)
    assert losses[0] == losses[1]


def test_chip_smoke_train_shapes_are_the_steps_gdn_launches(setup,
                                                            monkeypatch):
    """chip_smoke.py checks and times the GDN kernel at
    `gdn_train_shapes`: they are the (rows, C, inverse) of every GDN a
    train step's forward runs, in order."""
    import chip_smoke
    from mmnc_tpu_torch.ops import gdn as gdn_mod

    _, params, batch, noise = setup
    seen = []
    plain = gdn_mod.gdn_rows

    def record(x2d, gamma, beta, inverse):
        seen.append((x2d.shape[0], x2d.shape[1], inverse))
        return plain(x2d, gamma, beta, inverse)

    monkeypatch.setattr(gdn_mod, "gdn_rows", record)
    model = _port(params)
    model.loss_and_logs(batch, training=True, noise=_t_noise(noise))
    assert seen == chip_smoke.gdn_train_shapes(2, conv=4)
    assert len(seen) == chip_smoke.TRAIN_LAUNCHES["train"]["gdn"]
