"""The port's data parallelism (`mmnc_tpu_torch.parallel`) on the CPU:
ranks are processes over gloo, started by `parallel.launch`.

* `shard_batch` gives rank r rows r*B/N to (r+1)*B/N and raises where N
  does not divide B; `make_mesh` and `fit(n_devices=2)` raise outside a
  process group of that size.
* One train step of the shared codec (rgb + semantic, m=8, c=4 at 256 px)
  on a global batch of 4, from JAX's init params (conv kernels scaled)
  and one numpy noise: 2 ranks
  (2 rows each) against the port's single-process step and mmnc_tpu's
  step on the global batch (the tolerances of tests/test_train.py:95-103:
  loss rtol 1e-4, parameters rtol 2e-4 / atol 2e-6), the ranks' updated
  parameters bitwise equal, and their PSNR, mIoU and MS-SSIM logs the
  global batch's (rtol 1e-5 of the single-process step's). The eval step
  likewise.
* `fit` on 2 ranks over 20 steps gives the single-process loss trace
  (rtol 1e-4, as the one-step check; tests/test_fit_multichip.py holds
  JAX's mesh to 2e-3), from a prerendered host dataset and from a
  device-resident one; a SIGTERM in one rank stops every rank at the same
  step with one checkpoint.
* `python -m mmnc_tpu_torch.cli.train -g 2 --device cpu` against the same
  CLI on one process.
* `launch` raises with a failing rank's traceback, past its timeout
  when a rank hangs in a collective, and for more CUDA ranks than
  cards.

The rank functions are module-level (spawned ranks import this module),
and this module imports JAX only inside the tests that compare with it.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.data import (BatchLoader, DeviceResidentDataset,
                                 SyntheticMultiTaskDataset, prerender)
from mmnc_tpu_torch.parallel import Mesh, launch, make_mesh, shard_batch
from mmnc_tpu_torch.train import (create_train_state, fit, make_eval_step,
                                  make_train_step)
from mmnc_tpu_torch.utils.checkpoint import find_last_checkpoint

TASKS = ("rgb", "semantic")
LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS, CLIP = 1e-2, 1e-4, 1e-3, 10, 5.0
GLOBAL_BATCH = 4
TIMEOUT = 300  # seconds a launch of these tests may take


@pytest.fixture(autouse=True)
def two_threads():
    """launch splits this process's torch threads among its CPU ranks: one
    each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mesh(rank, n):
    return Mesh(rank, n, torch.device("cpu"), None, None)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_shard_batch_gives_each_rank_its_contiguous_rows(as_tensor):
    batch = {"rgb": np.arange(8 * 2, dtype=np.float32).reshape(8, 2),
             "semantic": np.arange(8, dtype=np.float32)}
    if as_tensor:
        batch = {t: torch.from_numpy(x) for t, x in batch.items()}
    for rank in range(4):
        got = shard_batch(batch, _mesh(rank, 4))
        for t, x in batch.items():
            np.testing.assert_array_equal(np.asarray(got[t]),
                                          np.asarray(x)[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="6 does not split into 4"):
        shard_batch({t: x[:6] for t, x in batch.items()}, _mesh(0, 4))


def test_make_mesh_and_fit_outside_a_process_group_raise(tmp_path):
    with pytest.raises(RuntimeError, match="parallel.launch"):
        make_mesh(2)
    model = build_model(1, ["mono"], 8, 4, device="cpu")
    loader = BatchLoader(prerender(SyntheticMultiTaskDataset(
        ["mono"], size=4, seed=0)), 2)
    with pytest.raises(RuntimeError, match="parallel.launch"):
        fit(model, loader, out_dir=str(tmp_path), n_devices=2)


# --- one step ----------------------------------------------------------------

def _shared_model(state_dict):
    model = build_model(4, TASKS, latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, learning_rate_main=LR_MAIN,
                        learning_rate_aux=LR_AUX, device="cpu")
    model.load_state_dict(state_dict)
    return model


def _step(mesh, state_dict, batch, noise):
    """One train step (clip CLIP) and then one eval step, on the global
    batch, or under a mesh on this rank's rows: -> (train logs, eval
    logs, parameters), as floats and numpy."""
    model = _shared_model(state_dict)
    state = create_train_state(model, TOTAL_STEPS)
    rows = batch if mesh is None else shard_batch(batch, mesh)
    _, logs = make_train_step(model, clip_norm=CLIP, mesh=mesh)(
        state, rows, noise={k: torch.from_numpy(v) for k, v in noise.items()})
    val = make_eval_step(model, mesh=mesh)(rows)
    return ({k: v.item() for k, v in logs.items()},
            {k: v.item() for k, v in val.items()},
            {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def step_case():
    """JAX's shared codec with its init params, conv kernels scaled (so y
    and z are not all near zero), a global batch of 4 and the step's
    noise; mmnc_tpu's train step and eval step on them.

    No noise is added to the params: a GDN gamma pushed below its bound
    gets a gradient at the level of float rounding, and Adam's first
    update, lr * g / (|g| + eps), then takes its sign from the order of
    a sum (test_torch_train.py)."""
    import jax
    import jax.numpy as jnp

    from mmnc_tpu.entropy import entropy_bottleneck as j_eb
    from mmnc_tpu.entropy import gaussian_conditional as j_gc
    from mmnc_tpu.models import build_model as j_build_model
    from mmnc_tpu.train import create_train_state as j_create_train_state
    from mmnc_tpu.train import make_eval_step as j_make_eval_step
    from mmnc_tpu.train import make_train_step as j_make_train_step
    from mmnc_tpu_torch.weights import state_dict_from_jax
    from test_torch_multitask import kernel_gain

    jmodel = j_build_model(4, TASKS, latent_channels=8, conv_channels=4,
                           lmbda=LMBDA)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * kernel_gain(path)).astype(
            np.float32), jax.device_get(variables["params"]))
    batch = jmodel.example_batch(GLOBAL_BATCH, seed=1)
    shapes = _shared_model(state_dict_from_jax(params)).latent_shapes(batch)
    rng = np.random.default_rng(0)
    noise = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
             for k, s in shapes.items()}
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}
    assert len(by_shape) == 2

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    jbatch = {t: jnp.asarray(x) for t, x in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        state = j_create_train_state(params, TOTAL_STEPS, LR_MAIN, LR_AUX)
        step = j_make_train_step(jmodel, compute_metrics=True, donate=False,
                                 clip_norm=CLIP)
        j_state, j_logs = step(state, jbatch, jax.random.PRNGKey(0))
    j_val = j_make_eval_step(jmodel)(j_state.params, jbatch)
    return {"state_dict": state_dict_from_jax(params), "batch": batch,
            "noise": noise,
            "jax_logs": {k: float(v) for k, v in
                         jax.device_get(j_logs).items()},
            "jax_val": {k: float(v) for k, v in
                        jax.device_get(j_val).items()},
            "jax_params": {k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(j_state.params)).items()}}


@pytest.fixture(scope="module")
def step_runs(step_case):
    """The port's step on one process and on 2 ranks."""
    args = (step_case["state_dict"], step_case["batch"], step_case["noise"])
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _step(None, *args), launch(_step, 2, "cpu", *args,
                                          timeout=TIMEOUT)
    finally:
        torch.set_num_threads(before)


def _assert_params(got, want, what):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-6,
                                   err_msg=f"{what}: {name}")


def test_two_rank_step_equals_the_global_batch_step(step_case, step_runs):
    single, ranks = step_runs
    (logs0, val0, params0), (logs1, val1, params1) = ranks
    # identical all-reduced gradients: identical updates and logs
    for name, p in params0.items():
        np.testing.assert_array_equal(params1[name], p, err_msg=name)
    assert logs0 == logs1 and val0 == val1
    for want, what in ((single[0], "single-process step"),
                       (step_case["jax_logs"], "mmnc_tpu's step")):
        assert set(logs0) == set(want)
        np.testing.assert_allclose(logs0["train/loss"], want["train/loss"],
                                   rtol=1e-4, err_msg=what)
    _assert_params(params0, single[2], "single-process step")
    _assert_params(params0, step_case["jax_params"], "mmnc_tpu's step")


@pytest.mark.parametrize("split", [0, 1], ids=["train", "eval"])
def test_two_rank_metric_logs_are_the_global_batch_values(step_runs, split):
    """PSNR and mIoU from the summed statistics, MS-SSIM averaged: the
    single-process values of the global batch, not per-shard averages."""
    single, ranks = step_runs
    prefix = ("train", "val")[split]
    names = [f"{prefix}/rgb/psnr", f"{prefix}/rgb/ms-ssim",
             f"{prefix}/semantic/psnr", f"{prefix}/semantic/miou",
             f"{prefix}/semantic/ms-ssim"]
    got, want = ranks[0][split], single[split]
    assert set(got) == set(want) and set(names) <= set(got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)


def test_two_rank_eval_step_equals_mmnc_tpu(step_case, step_runs):
    _, ranks = step_runs
    got, want = ranks[0][1], step_case["jax_val"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


# --- fit ---------------------------------------------------------------------

FIT_STEPS, FIT_BATCH = 20, 4


def _fit(mesh, out_dir, resident, sigterm_at=None):
    """fit of the mono codec (m=8, c=4, lr 1e-3) for FIT_STEPS steps on a
    batch of FIT_BATCH, 10 epochs of 2 batches, under `mesh` or on one
    process: -> (train loss trace {step: loss}, last val logs, final
    parameters). `sigterm_at`: the step in which rank 1 (or the single
    process) gets a SIGTERM."""
    arrays = prerender(SyntheticMultiTaskDataset(
        ["mono"], size=2 * FIT_BATCH, seed=0)).arrays
    data = (DeviceResidentDataset(arrays, device="cpu") if resident
            else prerender(SyntheticMultiTaskDataset(
                ["mono"], size=2 * FIT_BATCH, seed=0)))
    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        lmbda=1e-2, learning_rate_main=1e-3, device="cpu")
    if sigterm_at is not None and (mesh is None or mesh.rank == 1):
        draw = model.draw_noise
        calls = []

        def draw_then_sigterm(batch, generator):
            calls.append(1)
            if len(calls) == sigterm_at + 1:
                signal.raise_signal(signal.SIGTERM)
            return draw(batch, generator)

        model.draw_noise = draw_then_sigterm
    name = "mesh" if mesh is not None else "single"
    _, val_logs = fit(
        model, BatchLoader(data, FIT_BATCH), BatchLoader(
            data, FIT_BATCH, shuffle=False),
        epochs=10, run_name=name, out_dir=out_dir, max_steps=FIT_STEPS,
        log_every=1, compute_metrics=False, log_images=False,
        n_devices=None if mesh is None else mesh.world_size,
        val_every_epochs=5)
    trace = {}
    if mesh is None or mesh.lead:
        with open(os.path.join(out_dir, name, f"{name}.metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if "train/loss" in rec:
                    trace[rec["step"]] = rec["train/loss"]
    return trace, val_logs, {k: v.numpy().copy()
                             for k, v in model.state_dict().items()}


@pytest.mark.parametrize("resident", [False, True],
                         ids=["prefetch", "device_resident"])
def test_two_rank_fit_gives_the_single_process_loss_trace(tmp_path,
                                                          resident):
    out = str(tmp_path)
    trace, val_logs, params = _fit(None, out, resident)
    ranks = launch(_fit, 2, "cpu", out, resident, timeout=TIMEOUT)
    (r_trace, r_val, r_params), (empty, r_val1, r_params1) = ranks
    assert empty == {}  # rank 1 writes no metrics
    assert sorted(trace) == sorted(r_trace) == list(range(FIT_STEPS))
    for step, loss in trace.items():
        np.testing.assert_allclose(r_trace[step], loss, rtol=1e-4,
                                   err_msg=f"step {step}")
    assert r_val == r_val1 and set(r_val) == set(val_logs)
    for k, v in val_logs.items():
        np.testing.assert_allclose(r_val[k], v, rtol=1e-4, err_msg=k)
    for name, p in params.items():
        np.testing.assert_array_equal(r_params1[name], r_params[name])
        np.testing.assert_allclose(r_params[name], p, rtol=2e-4, atol=2e-6,
                                   err_msg=name)
    ckpts = os.path.join(out, "mesh", "checkpoints")
    assert find_last_checkpoint(ckpts).endswith(f"step_{FIT_STEPS}")


def test_sigterm_in_one_rank_stops_every_rank_with_one_checkpoint(tmp_path):
    with pytest.raises(SystemExit) as exc:
        launch(_fit, 2, "cpu", str(tmp_path), False, 3, timeout=TIMEOUT)
    assert exc.value.code == 143
    ckpts = os.path.join(str(tmp_path), "mesh", "checkpoints")
    # the ranks agreed after step 3 (0-based): the state after 4 steps
    assert os.listdir(ckpts) == ["step_4"]
    assert os.path.exists(os.path.join(ckpts, "step_4", "state.pt"))


# --- the train CLI -----------------------------------------------------------

def _cli_args(tmp_path, name, *extra):
    return ["-d", "synthetic", "-t", "mono", "-m", "1", "-l", "8", "-c", "4",
            "-w", name, "--lmbda", "1e-2", "--batch-size", "2",
            "--train-size", "8", "--val-size", "2", "--epochs", "1",
            "--out-dir", str(tmp_path / "runs"), "--data-cache-dir",
            str(tmp_path / "cache"), "--log-every", "1", "--device", "cpu",
            *extra]


def _records(tmp_path, name):
    with open(tmp_path / "runs" / name / f"{name}.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("time")
    return recs


def test_train_cli_on_two_ranks_equals_one_process(tmp_path):
    from mmnc_tpu_torch.cli.train import main

    state = main(_cli_args(tmp_path, "one"))
    ranks = main(_cli_args(tmp_path, "two", "-g", "2"))
    assert [r["step"] for r in ranks] == [state.step, state.step] == [4, 4]
    assert ranks[0]["val_logs"] == ranks[1]["val_logs"]
    one, two = _records(tmp_path, "one"), _records(tmp_path, "two")
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for a, b in zip(two, one):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    ckpt = find_last_checkpoint(str(tmp_path / "runs" / "two" /
                                    "checkpoints"))
    assert ckpt.endswith("step_4")
    for split in ("val", "train"):
        assert os.path.exists(tmp_path / "runs" / "two" /
                              f"samples_epoch0_{split}" / "mono.png")


# --- launch ------------------------------------------------------------------

def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here")
    mesh.barrier()


def _hang_rank_0(mesh):
    if mesh.rank == 0:
        time.sleep(120)
    mesh.barrier()


def test_launch_raises_with_a_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                       "ValueError: rank 1 stops here"):
        launch(_fail_on_rank_1, 2, "cpu", timeout=TIMEOUT)


def test_launch_raises_when_a_rank_hangs_a_collective():
    """Rank 1 waits in a barrier for rank 0, which sleeps 120 s: launch
    stops both at its timeout and raises."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past 15 s"):
        launch(_hang_rank_0, 2, "cpu", timeout=15)
    assert time.monotonic() - t0 < 60


def test_launch_raises_for_more_cuda_ranks_than_cards():
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"{cards + 1} CUDA ranks, but "
                       f"this machine has {cards} CUDA devices"):
        launch(_fail_on_rank_1, cards + 1, "cuda")
    with pytest.raises(ValueError, match="NCCL takes one rank per card"):
        launch(_fail_on_rank_1, 2, "cuda:0")
