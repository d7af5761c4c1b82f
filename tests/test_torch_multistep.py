"""K train steps per call (`make_multi_train_step`, `fit(steps_per_call=K)`,
`--steps-per-call`) of the port on the CPU.

The mono codec (m=8, c=4 at 256 px, batch 2, lr 1e-3) as
tests/test_train.py's `setup` builds it, from the port's seed-0 init,
carried to mmnc_tpu by its `import_reference_state_dict` (unnoised: a
gradient at float rounding would let Adam's first update take its sign
from the order of a sum; see test_torch_parallel.py). Torch runs 2
threads a test process here (`two_threads`), as the tests share the
host's cores with other test processes.

* K = 3 micro-steps in one call, from a super-batch {task: (K, B, ...)}
  or a list of K batches, are bitwise equal to 3 sequential
  `make_train_step` calls whose generator is reseeded at each step.
* The port's multi-step equals mmnc_tpu's `make_multi_train_step` on the
  same params and the same numpy noise at every micro-step (JAX's
  `quantize_noise` patched), at tests/test_train.py:140-169's tolerances:
  the loss rtol 1e-5, the parameters rtol 1e-4 / atol 1e-6.
* `fit(steps_per_call=2)` equals mmnc_tpu's `fit(steps_per_call=2)` (3
  batches an epoch, so each epoch drops its last) within rtol 1e-3 /
  atol 1e-4 (tests/test_torch_loop.py), with the same logged steps
  (from the params mmnc_tpu's `fit` initialises); it equals the port's
  `fit` with K = 1 bitwise where K divides the epoch;
  a K larger than the epoch is clamped (as
  test_fit_clamps_steps_per_call_to_epoch_length); the train CLI runs
  with --steps-per-call 2.
* `fit(steps_per_call=2, n_devices=2)` on 2 gloo ranks gives the single
  process's loss trace (rtol 1e-4) and parameters (rtol 2e-4 / atol
  2e-6), the ranks' parameters bitwise equal (tests/test_torch_parallel.py).

The rank function is module-level (spawned ranks import this module),
and this module imports JAX only inside the fixtures that run it.
"""

import json
import os

import numpy as np
import pytest
import torch

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                 prerender)
from mmnc_tpu_torch.parallel import launch
from mmnc_tpu_torch.train import (create_train_state, fit,
                                  make_multi_train_step, make_train_step)
from mmnc_tpu_torch.train.step import step_seed
from mmnc_tpu_torch.utils.checkpoint import find_last_checkpoint

LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS, K = 1e-2, 1e-3, 1e-3, 20, 3
SEED = 9
TIMEOUT = 300  # seconds a launch of these tests may take


@pytest.fixture(autouse=True)
def two_threads():
    """Torch on 2 threads: the tests share the host's cores with other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    """mmnc_tpu's mono codec, the port's seed-0 params (its state_dict,
    and as JAX params), a batch of 2 and K micro-batches batch + 0.01 s."""
    from mmnc_tpu.models import build_model as j_build_model
    from mmnc_tpu.utils.torch_import import import_reference_state_dict

    jmodel = j_build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA, learning_rate_main=LR_MAIN)
    state_dict = _port(None).state_dict()
    batch = next(iter(BatchLoader(_mono(4), 2, shuffle=False)))
    micro = [{t: (x + 0.01 * s).astype(np.float32) for t, x in batch.items()}
             for s in range(K)]
    return {"jmodel": jmodel, "micro": micro, "state_dict": state_dict,
            "params": import_reference_state_dict(state_dict, jmodel)}


def _port(state_dict):
    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, learning_rate_main=LR_MAIN,
                        learning_rate_aux=LR_AUX, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _mono(size, seed=0):
    return prerender(SyntheticMultiTaskDataset(["mono"], size=size,
                                               seed=seed))


def _adam(state):
    return {(i, k): v for i, s in state.optimizer.state_dict()["state"].items()
            for k, v in s.items()}


@pytest.mark.parametrize("form", ["stacked", "list"])
def test_k_steps_in_one_call_equal_k_sequential_steps_bitwise(setup, form):
    micro = setup["micro"]
    seq_model = _port(setup["state_dict"])
    seq_state = create_train_state(seq_model, TOTAL_STEPS)
    step = make_train_step(seq_model, compute_metrics=False)
    gen = torch.Generator()
    for batch in micro:
        gen.manual_seed(step_seed(SEED, seq_state.step))
        seq_state, seq_logs = step(seq_state, batch, gen)

    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K)
    super_batch = ({t: np.stack([m[t] for m in micro]) for t in micro[0]}
                   if form == "stacked" else micro)
    state, logs = multi(state, super_batch, torch.Generator(), SEED)

    assert state.step == seq_state.step == K
    assert set(logs) == set(seq_logs)
    for k, v in seq_logs.items():
        assert torch.equal(logs[k], v), k
    for name, p in seq_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name
    adam, seq_adam = _adam(state), _adam(seq_state)
    assert adam.keys() == seq_adam.keys() and adam
    for key, v in seq_adam.items():
        assert torch.equal(adam[key], v), key


def test_multi_step_refuses_a_wrong_group_or_no_noise(setup):
    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K)
    with pytest.raises(ValueError, match="2 micro-batches, want 3"):
        multi(state, setup["micro"][:2], torch.Generator(), SEED)
    stacked = {t: np.stack([m[t] for m in setup["micro"][:2]])
               for t in setup["micro"][0]}
    with pytest.raises(ValueError, match="leading extents \\[2\\]"):
        multi(state, stacked, torch.Generator(), SEED)
    with pytest.raises(ValueError, match="generator and a seed"):
        multi(state, setup["micro"], torch.Generator())
    assert state.step == 0


@pytest.fixture(scope="module")
def jax_multi(setup):
    """mmnc_tpu's K-step scan on the micro-batches with one numpy noise
    added at every micro-step."""
    import jax
    import jax.numpy as jnp

    from mmnc_tpu.entropy import entropy_bottleneck as j_eb
    from mmnc_tpu.entropy import gaussian_conditional as j_gc
    from mmnc_tpu.train import create_train_state as j_create_train_state
    from mmnc_tpu.train import make_multi_train_step as j_multi
    from mmnc_tpu_torch.weights import state_dict_from_jax

    rng = np.random.default_rng(5)
    noise = {"y": rng.uniform(-0.5, 0.5, (2, 1, 1, 8)).astype(np.float32),
             "z": rng.uniform(-0.5, 0.5, (2, 1, 1, 4)).astype(np.float32)}
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    micro = setup["micro"]
    super_batch = {t: np.stack([m[t] for m in micro]) for t in micro[0]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        state = j_create_train_state(setup["params"], TOTAL_STEPS,
                                     learning_rate_main=LR_MAIN,
                                     learning_rate_aux=LR_AUX)
        multi = j_multi(setup["jmodel"], steps_per_call=K, donate=False)
        state, logs = multi(state, super_batch, jax.random.PRNGKey(9))
    return {"noise": noise, "step": int(state.step),
            "loss": float(logs["train/loss"]),
            "params": {k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(state.params)).items()}}


def test_multi_step_equals_mmnc_tpus_multi_step(setup, jax_multi):
    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K)
    noise = {k: torch.from_numpy(v) for k, v in jax_multi["noise"].items()}
    state, logs = multi(state, setup["micro"], noise=noise)
    assert state.step == jax_multi["step"] == K
    np.testing.assert_allclose(logs["train/loss"].item(), jax_multi["loss"],
                               rtol=1e-5)
    got = model.state_dict()
    assert set(got) == set(jax_multi["params"])
    for name, want in jax_multi["params"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# --- fit -----------------------------------------------------------------

FIT_NOISE_SEED = 3


def _fit_noise():
    rng = np.random.default_rng(FIT_NOISE_SEED)
    return {"y": rng.uniform(-0.5, 0.5, (2, 1, 1, 8)).astype(np.float32),
            "z": rng.uniform(-0.5, 0.5, (2, 1, 1, 4)).astype(np.float32)}


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("time")
    return ([r for r in recs if "train/loss" in r],
            [r for r in recs if "val/loss" in r])


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """mmnc_tpu's fit with steps_per_call 2 over 2 epochs of 3 batches of
    2 (each epoch one call, its last batch dropped), logs every step,
    validation on one batch, the same noise at every step: its initial
    and final params, its records."""
    import jax
    import jax.numpy as jnp

    from mmnc_tpu.data import BatchLoader as JBatchLoader
    from mmnc_tpu.data import SyntheticMultiTaskDataset as JSynthetic
    from mmnc_tpu.entropy import entropy_bottleneck as j_eb
    from mmnc_tpu.entropy import gaussian_conditional as j_gc
    from mmnc_tpu.models import build_model as j_build_model
    from mmnc_tpu.train.loop import fit as j_fit

    out = str(tmp_path_factory.mktemp("jax_fit"))
    jmodel = j_build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA, learning_rate_main=LR_MAIN,
                           learning_rate_aux=LR_AUX)
    train = JBatchLoader(JSynthetic(["mono"], size=6, seed=0), 2)
    val = JBatchLoader(JSynthetic(["mono"], size=2, seed=10 ** 6), 2,
                       shuffle=False)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(21),
                                      next(iter(train)))["params"])
    by_shape = {v.shape: jnp.asarray(v) for v in _fit_noise().values()}

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        state, _ = j_fit(jmodel, train, val, epochs=2, run_name="run",
                         out_dir=out, log_every=1, log_images=False,
                         steps_per_call=2)
    from mmnc_tpu_torch.weights import state_dict_from_jax
    return {"init": state_dict_from_jax(init), "step": int(state.step),
            "final": {k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(state.params)).items()},
            "records": _records(os.path.join(out, "run",
                                             "run.metrics.jsonl"))}


def test_fit_with_steps_per_call_matches_jax_fit(jax_fit, tmp_path):
    model = _port(jax_fit["init"])
    noise = {k: torch.from_numpy(v) for k, v in _fit_noise().items()}
    model.draw_noise = lambda batch, generator: noise
    state, _ = fit(model, BatchLoader(_mono(6), 2),
                   BatchLoader(_mono(2, 10 ** 6), 2, shuffle=False),
                   epochs=2, run_name="run", out_dir=str(tmp_path),
                   log_every=1, log_images=False, steps_per_call=2)
    assert state.step == jax_fit["step"] == 4
    got = model.state_dict()
    for name, want in jax_fit["final"].items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    train, val = _records(os.path.join(str(tmp_path), "run",
                                       "run.metrics.jsonl"))
    j_train, j_val = jax_fit["records"]
    assert [r["step"] for r in train] == [r["step"] for r in j_train] \
        == [0, 2]
    assert [r["step"] for r in val] == [r["step"] for r in j_val] == [2, 4]
    for mine, theirs in zip(train + val, j_train + j_val):
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-3,
                                       atol=1e-4,
                                       err_msg=f"step {theirs['step']} {k}")


def _port_fit(out_dir, epochs=2, **kw):
    model = _port(None)
    state, _ = fit(model, BatchLoader(_mono(8), 2), epochs=epochs,
                   run_name="run", out_dir=out_dir, log_images=False,
                   compute_metrics=False, **kw)
    return model, state


def test_fit_with_steps_per_call_equals_single_steps_bitwise(tmp_path):
    """4 batches an epoch: K = 2 and K = 4 train what K = 1 trains."""
    one, s1 = _port_fit(str(tmp_path / "k1"), epochs=1, log_every=1)
    for k in (2, 4):
        model, state = _port_fit(str(tmp_path / f"k{k}"), epochs=1,
                                 log_every=1, steps_per_call=k)
        assert state.step == s1.step == 4
        for name, p in one.state_dict().items():
            assert torch.equal(model.state_dict()[name], p), (k, name)
        train, _ = _records(os.path.join(str(tmp_path), f"k{k}", "run",
                                         "run.metrics.jsonl"))
        assert [r["step"] for r in train] == list(range(0, 4, k))


def test_fit_cadence_of_logs_and_max_steps_follows_the_call(tmp_path):
    """The logs are pulled on calls whose first step is a multiple of
    log_every; max_steps stops after the call that reaches it."""
    _, state = _port_fit(str(tmp_path), log_every=3, steps_per_call=2,
                         max_steps=5)
    assert state.step == 6
    train, _ = _records(os.path.join(str(tmp_path), "run",
                                     "run.metrics.jsonl"))
    assert [r["step"] for r in train] == [0]
    last = find_last_checkpoint(os.path.join(str(tmp_path), "run",
                                             "checkpoints"))
    assert last.endswith("step_6")


def test_fit_clamps_steps_per_call_to_epoch_length(tmp_path, capsys):
    state, _ = fit(_port(None), BatchLoader(_mono(4), 2, shuffle=False),
                   val_loader=None, epochs=1, run_name="clamp",
                   out_dir=str(tmp_path), compute_metrics=False,
                   log_images=False, steps_per_call=8, log_every=100)
    assert state.step == 2
    assert "steps_per_call 8 > 2 batches/epoch — clamping" in \
        capsys.readouterr().out


def test_train_cli_runs_steps_per_call(tmp_path):
    from mmnc_tpu_torch.cli.train import main

    state = main(["-d", "synthetic", "-t", "mono", "-m", "1", "-l", "8",
                  "-c", "4", "-w", "k2", "--lmbda", "1e-2", "--batch-size",
                  "2", "--train-size", "8", "--val-size", "2",
                  "--no-metrics", "--epochs", "1", "--steps-per-call", "2",
                  "--out-dir", str(tmp_path / "runs"), "--data-cache-dir",
                  str(tmp_path / "cache"), "--log-every", "1", "--device",
                  "cpu"])
    assert state.step == 4
    train, val = _records(str(tmp_path / "runs" / "k2" / "k2.metrics.jsonl"))
    assert [r["step"] for r in train] == [0, 2]
    assert [r["step"] for r in val] == [4]
    assert find_last_checkpoint(str(tmp_path / "runs" / "k2" /
                                    "checkpoints")).endswith("step_4")


# --- 2 gloo ranks ----------------------------------------------------------

DP_BATCH, DP_STEPS = 4, 6


def _dp_fit(mesh, out_dir):
    """fit with steps_per_call 2 for DP_STEPS steps at a global batch of
    DP_BATCH, on one process or as a rank -> (loss trace {step: loss},
    parameters)."""
    model = _port(None)
    name = "single" if mesh is None else "mesh"
    fit(model, BatchLoader(_mono(2 * DP_BATCH), DP_BATCH), epochs=10,
        run_name=name, out_dir=out_dir, max_steps=DP_STEPS, log_every=1,
        compute_metrics=False, log_images=False, steps_per_call=2,
        n_devices=None if mesh is None else mesh.world_size)
    trace = {}
    if mesh is None or mesh.lead:
        train, _ = _records(os.path.join(out_dir, name,
                                         f"{name}.metrics.jsonl"))
        trace = {r["step"]: r["train/loss"] for r in train}
    return trace, {k: v.numpy().copy() for k, v in model.state_dict().items()}


def test_two_rank_fit_with_steps_per_call_equals_one_process(tmp_path):
    trace, params = _dp_fit(None, str(tmp_path))
    (r_trace, r_params), (empty, r_params1) = launch(
        _dp_fit, 2, "cpu", str(tmp_path), timeout=TIMEOUT)
    assert empty == {}
    assert sorted(trace) == sorted(r_trace) == [0, 2, 4]
    for step, loss in trace.items():
        np.testing.assert_allclose(r_trace[step], loss, rtol=1e-4,
                                   err_msg=f"step {step}")
    for name, p in params.items():
        np.testing.assert_array_equal(r_params1[name], r_params[name])
        np.testing.assert_allclose(r_params[name], p, rtol=2e-4, atol=2e-6,
                                   err_msg=name)
