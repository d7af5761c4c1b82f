"""The port's train loop (`mmnc_tpu_torch.train.fit`) on the CPU.

Against mmnc_tpu's `fit`: the single-task rgb codec (c=4, m=8 at 256 px)
from the params JAX's fit initialises (`model.init(PRNGKey(21), first
batch)`, carried over by `state_dict_from_jax`), 2 epochs of 2 batches of
2 with validation, logs pulled every step. The same numpy noise is patched
into both packages (JAX's `quantize_noise` in the two entropy modules, the
port's `draw_noise`); JAX traces its step once, so the noise is the same
at every step. Final params, the JSONL train and val records within rtol
1e-3 / atol 1e-4.

The port alone: a run of 2 steps resumed to 4 is bitwise equal to 4
uninterrupted steps (the per-step reseeded noise, Adam's state and the
schedule are restored exactly); the saved horizon is kept or extended as
mmnc_tpu's loop says; a SIGTERM inside a step saves a checkpoint; three
non-finite losses abort (n_devices > 1: tests/test_torch_parallel.py;
steps_per_call > 1: tests/test_torch_multistep.py)."""

import json
import os
import signal

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.data import BatchLoader as JBatchLoader
from mmnc_tpu.data import SyntheticMultiTaskDataset as JSynthetic
from mmnc_tpu.entropy import entropy_bottleneck as j_eb
from mmnc_tpu.entropy import gaussian_conditional as j_gc
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.train.loop import fit as j_fit

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                 prerender)
from mmnc_tpu_torch.train import fit
from mmnc_tpu_torch.utils.checkpoint import find_last_checkpoint
from mmnc_tpu_torch.weights import state_dict_from_jax

LMBDA, LR_MAIN, LR_AUX = 1e-2, 1e-4, 1e-3
RTOL, ATOL = 1e-3, 1e-4


def _datasets():
    train = SyntheticMultiTaskDataset(["rgb"], size=4, seed=0)
    val = SyntheticMultiTaskDataset(["rgb"], size=2, seed=10 ** 6)
    return prerender(train), prerender(val)


def _noise():
    rng = np.random.default_rng(3)
    return {"y": rng.uniform(-0.5, 0.5, (2, 1, 1, 8)).astype(np.float32),
            "z": rng.uniform(-0.5, 0.5, (2, 1, 1, 4)).astype(np.float32)}


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("time")
    train = [r for r in recs if any(k.startswith("train/") for k in r)]
    val = [r for r in recs if any(k.startswith("val/") for k in r)]
    return train, val


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """mmnc_tpu's fit over the data, its initial and final params and its
    JSONL records."""
    out = str(tmp_path_factory.mktemp("jax_fit"))
    jmodel = j_build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA, learning_rate_main=LR_MAIN,
                           learning_rate_aux=LR_AUX)
    train = JSynthetic(["rgb"], size=4, seed=0)
    val = JSynthetic(["rgb"], size=2, seed=10 ** 6)
    train_loader = JBatchLoader(train, 2)
    val_loader = JBatchLoader(val, 2, shuffle=False)
    first = next(iter(train_loader))
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(21), first)["params"])
    by_shape = {v.shape: jnp.asarray(v) for v in _noise().values()}

    def fixed(x, rng):
        del rng
        return x + by_shape[tuple(x.shape)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        state, val_logs = j_fit(jmodel, train_loader, val_loader, epochs=2,
                                run_name="run", out_dir=out, log_every=1,
                                log_images=False)
    return {"init": init, "final": jax.device_get(state.params),
            "val_logs": val_logs,
            "records": _records(os.path.join(out, "run",
                                             "run.metrics.jsonl"))}


def _port_model(params=None):
    model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, learning_rate_main=LR_MAIN,
                        learning_rate_aux=LR_AUX, device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params))
    return model


def _fixed_noise(model):
    noise = {k: torch.from_numpy(v) for k, v in _noise().items()}
    model.draw_noise = lambda batch, generator: noise


def _loaders():
    train, val = _datasets()
    return BatchLoader(train, 2), BatchLoader(val, 2, shuffle=False)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_fit_matches_jax_fit(jax_fit, tmp_path):
    model = _port_model(jax_fit["init"])
    _fixed_noise(model)
    train_loader, val_loader = _loaders()
    state, val_logs = fit(model, train_loader, val_loader, epochs=2,
                          run_name="run", out_dir=str(tmp_path), log_every=1)
    assert state.step == 4 and state.total_steps == 4

    want = state_dict_from_jax(jax_fit["final"])
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name].numpy(), np.asarray(w), name)

    train, val = _records(os.path.join(str(tmp_path), "run",
                                       "run.metrics.jsonl"))
    j_train, j_val = jax_fit["records"]
    assert [r["step"] for r in train] == [r["step"] for r in j_train] \
        == [0, 1, 2, 3]
    assert [r["step"] for r in val] == [r["step"] for r in j_val] == [2, 4]
    for mine, theirs in zip(train + val, j_train + j_val):
        assert set(mine) == set(theirs)
        for k in theirs:
            _close(mine[k], theirs[k], f"step {theirs['step']} {k}")
    assert set(val_logs) == set(jax_fit["val_logs"])
    for k, v in jax_fit["val_logs"].items():
        _close(val_logs[k], v, k)
    # the image grids of both validation epochs
    for epoch in (0, 1):
        for split in ("val", "train"):
            assert os.path.exists(os.path.join(
                str(tmp_path), "run", f"samples_epoch{epoch}_{split}",
                "rgb.png"))


def _run(out_dir, epochs, resume=False, **kw):
    model = _port_model()
    train_loader, val_loader = _loaders()
    state, _ = fit(model, train_loader, val_loader, epochs=epochs,
                   run_name="run", out_dir=out_dir, resume=resume,
                   log_every=1, log_images=False, compute_metrics=False,
                   **kw)
    return model, state


def _adam_tensors(state):
    sd = state.optimizer.state_dict()["state"]
    return {(i, k): v for i, s in sd.items() for k, v in s.items()}


def test_resumed_run_equals_uninterrupted_run_bitwise(tmp_path):
    a = str(tmp_path / "a")
    _run(a, epochs=1, schedule_total_steps=4)
    assert find_last_checkpoint(os.path.join(a, "run", "checkpoints")
                                ).endswith("step_2")
    resumed, state_r = _run(a, epochs=2, resume=True)
    whole, state_w = _run(str(tmp_path / "b"), epochs=2)
    assert state_r.step == state_w.step == 4
    assert state_r.total_steps == state_w.total_steps == 4
    for name, p in whole.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], p), name
    adam_r, adam_w = _adam_tensors(state_r), _adam_tensors(state_w)
    assert adam_r.keys() == adam_w.keys() and adam_w
    for key, v in adam_w.items():
        assert torch.equal(adam_r[key], v), key


@pytest.mark.parametrize("extend", [False, True])
def test_resume_keeps_or_extends_the_saved_horizon(tmp_path, extend):
    out = str(tmp_path)
    _run(out, epochs=1)  # 2 steps, horizon 2
    _, state = _run(out, epochs=2, resume=True, extend_schedule=extend)
    want = 4 if extend else 2
    assert state.step == 4 and state.total_steps == want
    last = find_last_checkpoint(os.path.join(out, "run", "checkpoints"))
    with open(os.path.join(last, "hyper_parameters.json")) as f:
        hp = json.load(f)
    assert last.endswith("step_4") and hp["total_steps"] == want
    assert hp["model_class"] == "SingleTaskCompressor"


def test_sigterm_inside_a_step_saves_a_checkpoint(tmp_path):
    model = _port_model()
    draw = model.draw_noise
    seen = []

    def draw_then_sigterm(batch, generator):
        seen.append(1)
        if len(seen) == 2:  # inside the second step: state.step is 1
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "fit installed no SIGTERM handler"
            signal.raise_signal(signal.SIGTERM)
        return draw(batch, generator)

    model.draw_noise = draw_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    train_loader, _ = _loaders()
    with pytest.raises(SystemExit) as exc:
        fit(model, train_loader, epochs=2, out_dir=str(tmp_path),
            run_name="run", log_every=1, compute_metrics=False)
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is before
    last = find_last_checkpoint(os.path.join(str(tmp_path), "run",
                                             "checkpoints"))
    assert last is not None and last.endswith("step_1")
    assert os.path.exists(os.path.join(last, "state.pt"))


def test_three_non_finite_losses_abort(tmp_path):
    model = _port_model()
    loss_and_logs = model.loss_and_logs

    def blown_up(*args, **kwargs):
        loss, rest = loss_and_logs(*args, **kwargs)
        return loss * float("nan"), rest

    model.loss_and_logs = blown_up
    train_loader = BatchLoader(prerender(SyntheticMultiTaskDataset(
        ["rgb"], size=8, seed=0)), 2)
    # step 0 logs the loss of finite params; its NaN gradients make every
    # later loss NaN: the checks of steps 1, 2 and 3 abort the run
    with pytest.raises(RuntimeError, match="diverged.*step 3"):
        fit(model, train_loader, epochs=1, out_dir=str(tmp_path),
            run_name="run", log_every=1, compute_metrics=False)
