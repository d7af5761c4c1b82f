"""The port's CLIs and checkpoints on the CPU.

* `python -m mmnc_tpu_torch.cli.train` end to end with the flags of
  tests/test_harness.py plus --device cpu: a checkpoint, train and val
  JSONL records, and --resume continuing from the saved step.
* The compress CLI against mmnc_tpu's: one set of params (JAX's init,
  conv kernels scaled so y is not all zero) saved as a JAX checkpoint and
  as a port checkpoint; each CLI compresses the same synthetic batch from
  its own: the --out bytes and the actual bpp equal, the estimates within
  1e-5.
* `rebuild_model_from_checkpoint` on a hyper_parameters.json written as
  mmnc_tpu writes it: for models 1-4 the model's state_dict has the keys
  and shapes `state_dict_from_jax` gives for JAX's params.
* -g 2: tests/test_torch_parallel.py; --steps-per-call 2:
  tests/test_torch_multistep.py.
* The image grid, written without an image library, decodes through PIL
  to the pixels of mmnc_tpu's grid."""

import json
import os

import numpy as np
import pytest
import torch
import jax
from PIL import Image

from mmnc_tpu.cli.compress import main as j_compress_main
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.train import create_train_state as j_create_train_state
from mmnc_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mmnc_tpu.utils.logging import save_image_grid as j_save_image_grid

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.cli.compress import main as compress_main
from mmnc_tpu_torch.cli.train import main as train_main
from mmnc_tpu_torch.train import create_train_state
from mmnc_tpu_torch.utils.checkpoint import (find_last_checkpoint,
                                             rebuild_model_from_checkpoint,
                                             save_checkpoint)
from mmnc_tpu_torch.utils.logging import save_image_grid
from mmnc_tpu_torch.weights import state_dict_from_jax

from test_torch_multitask import kernel_gain


def _train_args(tmp_path, *extra):
    return ["-d", "synthetic", "-t", "mono", "-m", "1", "-l", "8", "-c", "4",
            "-w", "clitest", "--lmbda", "1e-2", "--batch-size", "2",
            "--train-size", "8", "--val-size", "2", "--no-metrics",
            "--out-dir", str(tmp_path / "runs"), "--data-cache-dir",
            str(tmp_path / "cache"), "--log-every", "1", "--device", "cpu",
            *extra]


def _records(tmp_path):
    with open(tmp_path / "runs" / "clitest" / "clitest.metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_end_to_end_and_resume(tmp_path):
    state = train_main(_train_args(tmp_path, "--epochs", "1",
                                   "--max-steps", "4"))
    assert state.step == 4
    ckpt_dir = str(tmp_path / "runs" / "clitest" / "checkpoints")
    ckpt = find_last_checkpoint(ckpt_dir)
    assert ckpt is not None and ckpt.endswith("step_4")
    with open(os.path.join(ckpt, "hyper_parameters.json")) as f:
        hp = json.load(f)
    assert hp["model_class"] == "SingleTaskCompressor"
    assert hp["tasks"] == ["mono"] and hp["total_steps"] == 4
    recs = _records(tmp_path)
    assert [r["step"] for r in recs if "train/loss" in r] == [0, 1, 2, 3]
    assert any("val/loss" in r for r in recs)
    assert all(np.isfinite(v) for r in recs for v in r.values())

    # resume: epoch 1 of 2 continues from step 4 and stops at --max-steps
    state = train_main(_train_args(tmp_path, "--epochs", "2",
                                   "--max-steps", "6", "--resume"))
    assert state.step == 6
    assert find_last_checkpoint(ckpt_dir).endswith("step_6")
    steps = [r["step"] for r in _records(tmp_path) if "train/loss" in r]
    assert steps == [0, 1, 2, 3, 4, 5]


def test_compress_cli_matches_jax_cli(tmp_path):
    jmodel = j_build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                           lmbda=1e-2)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * kernel_gain(path)).astype(
            np.float32), jax.device_get(variables["params"]))
    j_path = j_save_checkpoint(str(tmp_path / "jax"), 3,
                               j_create_train_state(params, 10),
                               {**jmodel.hyper_parameters, "total_steps": 10})
    port = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                       lmbda=1e-2, device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    t_path = save_checkpoint(str(tmp_path / "port"), 3, port,
                             create_train_state(port, 10),
                             {**port.hyper_parameters, "total_steps": 10})
    args = ["-d", "synthetic", "--batch-size", "2", "--num-batches", "1"]
    j_bpp, j_est = j_compress_main(["-p", j_path, *args,
                                    "--out", str(tmp_path / "jax.bin")])
    t_bpp, t_est = compress_main(["-p", t_path, *args, "--device", "cpu",
                                  "--out", str(tmp_path / "port.bin")])
    j_bytes = (tmp_path / "jax.bin").read_bytes()
    t_bytes = (tmp_path / "port.bin").read_bytes()
    assert len(j_bytes) > 32  # y and z strings, each behind its length
    assert t_bytes == j_bytes
    assert t_bpp == j_bpp and t_bpp > 0
    assert abs(t_est - j_est) <= 1e-5 and t_est > 0


TASKS3 = ["rgb", "depth_euclidean", "semantic"]


@pytest.mark.parametrize("number", [1, 2, 3, 4])
def test_rebuild_from_a_jax_written_checkpoint(tmp_path, number):
    tasks = ["rgb"] if number == 1 else TASKS3
    jmodel = j_build_model(number, tasks, latent_channels=8, conv_channels=4,
                           lmbda=1e-2)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jmodel.example_batch(image_size=256)))
    want = state_dict_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes["params"]))
    path = tmp_path / "step_1"
    path.mkdir()
    # what mmnc_tpu's save_checkpoint writes beside its state
    with open(path / "hyper_parameters.json", "w") as f:
        json.dump({**jmodel.hyper_parameters, "total_steps": 5}, f, indent=2)
    model, hp = rebuild_model_from_checkpoint(str(path), "cpu")
    assert model.get_model_name() == jmodel.get_model_name()
    assert model.tasks == jmodel.tasks and hp["total_steps"] == 5
    assert model.latent_channels == jmodel.latent_channels
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name


def test_checkpoint_round_trip_restores_model_and_adam(tmp_path):
    from mmnc_tpu_torch.utils.checkpoint import restore_checkpoint

    model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        device="cpu")
    state = create_train_state(model, 7)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    path = save_checkpoint(str(tmp_path), state.step, model, state,
                           {**model.hyper_parameters, "total_steps": 7})
    payload, hp = restore_checkpoint(path, "cpu")
    assert payload["step"] == 1 and hp["total_steps"] == 7
    fresh = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        device="cpu", seed=1)
    fresh.load_state_dict(payload["model"])
    restored = create_train_state(fresh, 1).load_state_dict(
        payload["optimizer"])
    assert restored.step == 1 and restored.total_steps == 7
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
    want = state.optimizer.state_dict()
    got = restored.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_image_grid_decodes_to_jax_pixels(tmp_path):
    rng = np.random.default_rng(0)
    x_hats = {"rgb": rng.random((3, 16, 16, 3)) * 1.2 - 0.1,
              "semantic": rng.random((3, 16, 16, 17)),
              "mono": rng.random((3, 16, 16, 1))}
    targets = {"rgb": rng.random((3, 16, 16, 3)),
               "semantic": np.floor(rng.random((3, 16, 16, 1)) * 17),
               "mono": rng.random((3, 16, 16, 1))}
    j_save_image_grid(str(tmp_path / "jax"), x_hats, targets, max_items=2)
    save_image_grid(str(tmp_path / "port"), x_hats, targets, max_items=2)
    for task in x_hats:
        want = np.asarray(Image.open(tmp_path / "jax" / f"{task}.png"))
        img = Image.open(tmp_path / "port" / f"{task}.png")
        assert img.mode == "RGB"
        got = np.asarray(img)
        assert got.shape == want.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want)
