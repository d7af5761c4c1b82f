"""The training slice's functions against mmnc_tpu on the CPU: losses,
rate formulas, metrics, the quantizers, and the gradients of the ops the
training path newly differentiates (softplus, abs, the bounds, GDN's
closed form on a strided gradient).

Inputs come from a numpy seed and go to both packages as the same arrays.
Tolerance: float32 sums taken in another order, rtol 1e-5 (1e-4 for the
filtered metrics); gradients of elementwise ops are exact."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.models import losses as JL
from mmnc_tpu.ops import metrics as JM
from mmnc_tpu.ops.bound import lower_bound as j_lower_bound
from mmnc_tpu.ops.bound import upper_bound as j_upper_bound
from mmnc_tpu.ops.quant import quantize_ste as j_quantize_ste

from mmnc_tpu_torch.entropy.entropy_bottleneck import _softplus
from mmnc_tpu_torch.models import losses as TL
from mmnc_tpu_torch.ops import metrics as TM
from mmnc_tpu_torch.ops.bound import abs_, lower_bound, upper_bound
from mmnc_tpu_torch.ops.gdn import GDNFunction
from mmnc_tpu_torch.ops.quant import (quantize_noise, quantize_ste,
                                      uniform_noise)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("loss_type", ["mse", "l1"])
def test_reconstruction_loss_matches_jax(loss_type):
    rng = np.random.default_rng(0)
    x = rng.random((3, 9, 7, 3)).astype(np.float32)
    xh = rng.normal(size=x.shape).astype(np.float32)
    _close(TL.reconstruction_loss(_t(xh), _t(x), loss_type),
           JL.reconstruction_loss(jnp.asarray(xh), jnp.asarray(x), loss_type))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(2, 6, 5, 17))).astype(np.float32)
    labels = np.floor(rng.random((2, 6, 5, 1)) * 16.99).astype(np.float32)
    _close(TL.reconstruction_loss(_t(logits), _t(labels), "cross-entropy"),
           JL.reconstruction_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  "cross-entropy"))


def test_unknown_loss_type_raises():
    with pytest.raises(NotImplementedError):
        TL.reconstruction_loss(torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 1, 1),
                               "huber")


@pytest.mark.parametrize("with_log_vars", [False, True])
def test_multitask_reconstruction_loss_matches_jax(with_log_vars):
    """Three tasks, one of them with a zero loss (its weighted term is
    masked out, log_var included)."""
    rng = np.random.default_rng(2)
    tasks = ("rgb", "depth", "semantic")
    types = {"rgb": "mse", "depth": "l1", "semantic": "cross-entropy"}
    x = {"rgb": rng.random((2, 4, 4, 3)), "depth": rng.random((2, 4, 4, 1)),
         "semantic": np.floor(rng.random((2, 4, 4, 1)) * 16.99)}
    xh = {"rgb": rng.normal(size=(2, 4, 4, 3)), "depth": x["depth"],
          "semantic": rng.normal(size=(2, 4, 4, 17))}
    log_vars = rng.normal(size=3).astype(np.float32) if with_log_vars else None
    got, got_logs = TL.multitask_reconstruction_loss(
        {k: _t(v) for k, v in x.items()}, {k: _t(v) for k, v in xh.items()},
        tasks, types, None if log_vars is None else _t(log_vars))
    want, want_logs = JL.multitask_reconstruction_loss(
        {k: jnp.asarray(v, jnp.float32) for k, v in x.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in xh.items()},
        tasks, types, None if log_vars is None else jnp.asarray(log_vars))
    _close(got, want)
    assert set(got_logs) == set(want_logs)
    for k in want_logs:
        _close(got_logs[k], want_logs[k])


def test_uncertainty_weighted_sum_matches_jax():
    losses = {"a": np.float32(2.5), "b": np.float32(0.0), "c": np.float32(7.0)}
    log_vars = np.array([0.3, -1.2, 0.7], np.float32)
    _close(TL.uncertainty_weighted_sum(
        {k: torch.tensor(v) for k, v in losses.items()}, _t(log_vars)),
           JL.uncertainty_weighted_sum(
               {k: jnp.asarray(v) for k, v in losses.items()},
               jnp.asarray(log_vars)))


def _likelihoods(rng, y_shape=(2, 4, 4, 12), z_shape=(2, 1, 1, 6)):
    return {"y": (0.01 + 0.99 * rng.random(y_shape)).astype(np.float32),
            "z": (0.01 + 0.99 * rng.random(z_shape)).astype(np.float32)}


@pytest.mark.parametrize("variant", ["mixed", "disjoint", "shared"])
def test_rate_formulas_match_jax(variant):
    rng = np.random.default_rng(3)
    tasks = ("rgb", "depth") if variant == "disjoint" else ("rgb", "depth",
                                                            "normal")
    liks = _likelihoods(rng)
    x_hats = {t: np.zeros((2, 64, 64, 3), np.float32) for t in tasks}
    args = {"mixed": (), "disjoint": (6,), "shared": (3,)}[variant]
    fn_t = getattr(TL, f"compression_loss_{variant}")
    fn_j = getattr(JL, f"compression_loss_{variant}")
    got, got_logs = fn_t({k: _t(v) for k, v in liks.items()},
                         {k: _t(v) for k, v in x_hats.items()}, tasks, *args)
    want, want_logs = fn_j({k: jnp.asarray(v) for k, v in liks.items()},
                           {k: jnp.asarray(v) for k, v in x_hats.items()},
                           tasks, *args)
    _close(got, want)
    assert set(got_logs) == set(want_logs)
    for k in want_logs:
        _close(got_logs[k], want_logs[k])
    _close(TL.bits_per_pixel(_t(liks["y"]), 4096),
           JL.bits_per_pixel(jnp.asarray(liks["y"]), 4096))


def test_psnr_matches_jax():
    rng = np.random.default_rng(4)
    a = (255 * rng.random((2, 16, 16, 3))).astype(np.float32)
    b = np.clip(a + 10 * rng.normal(size=a.shape), 0, 255).astype(np.float32)
    _close(TM.psnr(_t(a), _t(b), 255.0), JM.psnr(jnp.asarray(a),
                                                 jnp.asarray(b), 255.0))
    _close(TM.psnr(_t(a), _t(a), 255.0), JM.psnr(jnp.asarray(a),
                                                 jnp.asarray(a), 255.0))


def test_miou_matches_jax():
    """Classes 13-16 never appear in the target: they are left out."""
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 17, (2, 9, 11))
    target = rng.integers(0, 13, (2, 9, 11))
    _close(TM.miou(torch.from_numpy(pred), torch.from_numpy(target)),
           JM.miou(jnp.asarray(pred), jnp.asarray(target)))


def _image_pair(seed, shape):
    rng = np.random.default_rng(seed)
    target = (255 * rng.random(shape)).astype(np.float32)
    pred = np.clip(target + 30 * rng.normal(size=shape), 0, 255
                   ).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("shape", [(2, 256, 256, 3), (1, 177, 181, 2)])
def test_ms_ssim_matches_jax(shape):
    """256 px (even at every scale) and an odd size (the symmetric
    zero-padded pooling at every scale)."""
    pred, target = _image_pair(6, shape)
    got = TM.ms_ssim(_t(pred), _t(target), 255.0)
    want = JM.ms_ssim(jnp.asarray(pred), jnp.asarray(target), 255.0)
    _close(got, want, rtol=1e-4)
    assert 0.0 < float(got) < 1.0


def test_ssim_matches_jax():
    pred, target = _image_pair(7, (2, 33, 29, 3))
    _close(TM.ssim(_t(pred), _t(target), 255.0),
           JM.ssim(jnp.asarray(pred), jnp.asarray(target), 255.0), rtol=1e-4)


def test_quantize_ste_value_and_gradient_match_jax():
    rng = np.random.default_rng(8)
    x = (4 * rng.normal(size=(3, 5))).astype(np.float32)
    x[0, :3] = (-1.5, 0.5, 2.5)  # ties round to even
    medians = rng.normal(size=(5,)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    for m in (None, medians):
        xt = _t(x).requires_grad_(True)
        mt = None if m is None else _t(m)
        out = quantize_ste(xt, mt)
        torch.sum(torch.sin(out) * _t(w)).backward()

        def f(a):
            return jnp.sum(jnp.sin(j_quantize_ste(
                a, None if m is None else jnp.asarray(m))) * w)

        _close(out.detach(), j_quantize_ste(
            jnp.asarray(x), None if m is None else jnp.asarray(m)))
        _close(xt.grad, jax.grad(f)(jnp.asarray(x)))


def test_uniform_noise_is_seeded_and_in_range():
    a = uniform_noise((4, 1, 1, 8), torch.Generator().manual_seed(3))
    b = uniform_noise((4, 1, 1, 8), torch.Generator().manual_seed(3))
    c = uniform_noise((4, 1, 1, 8), torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    x = torch.randn(4, 1, 1, 8)
    assert torch.equal(quantize_noise(x, a), x + a)


def _grad(fn, x, g):
    xt = _t(x).requires_grad_(True)
    fn(xt).backward(_t(g))
    return xt.grad.numpy()


def test_softplus_and_abs_gradients_match_jax_at_zero():
    """jnp.abs passes +g at 0 (torch.abs gives 0); jax.nn.softplus's
    gradient at 0 is 1/2 (autograd through max + log1p(exp(-|x|)) gives
    1). The port's ops carry JAX's gradients."""
    x = np.array([0.0, -0.0, 1e-3, -1e-3, 2.0, -2.0, 30.0, -30.0], np.float32)
    g = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    _, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    _close(_grad(_softplus, x, g), vjp(jnp.asarray(g))[0], rtol=1e-6)
    _close(_softplus(_t(x)).detach(), jax.nn.softplus(jnp.asarray(x)),
           rtol=1e-6)
    _, vjp = jax.vjp(jnp.abs, jnp.asarray(x))
    np.testing.assert_array_equal(_grad(abs_, x, g), vjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(abs_(_t(x)).numpy(), np.abs(x))


@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bound_gradients_match_jax(which):
    """Inside, at and outside the bound, under gradients of both signs."""
    x = np.array([-1.0, 0.11, 0.5, -1.0, 0.11, 0.5], np.float32)
    g = np.array([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], np.float32)
    port, ref = ((lower_bound, j_lower_bound) if which == "lower"
                 else (upper_bound, j_upper_bound))
    _, vjp = jax.vjp(lambda a: ref(a, 0.11), jnp.asarray(x))
    np.testing.assert_array_equal(_grad(lambda a: port(a, 0.11), x, g),
                                  vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_takes_a_strided_gradient(inverse):
    """The gradient reaching GDN can be a permuted view; the closed form
    gives what it gives for the same values laid out contiguously."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    gamma = (0.1 * np.eye(5) + 0.02 * rng.random((5, 5))).astype(np.float32)
    beta = (1 + rng.random(5)).astype(np.float32)
    g = rng.normal(size=(5, 12)).astype(np.float32)

    def grads(grad_out):
        args = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
        GDNFunction.apply(*args, inverse).backward(grad_out)
        return [a.grad for a in args]

    strided = _t(g).t()
    assert not strided.is_contiguous()
    for a, b in zip(grads(strided), grads(strided.contiguous())):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
