"""The port's RD sweep (`python -m mmnc_tpu_torch.cli.rd_sweep`) on the
CPU.

tests/test_cli_extras.py's tiny sweep (mono, m=8, c=4, one lambda, 2
steps at batch 2) through the port and through mmnc_tpu from the same
weights (the params JAX's fit initialises, carried over by
`state_dict_from_jax`) and the same numpy noise at every step (JAX's
`quantize_noise` patched, the port's `draw_noise` replaced, as
tests/test_torch_loop.py does): the RD points within rtol 1e-3 / atol
1e-4, rd_points.json and the plot written. Then the sweep alone (no
plot) with `-g 2` against one process, each drawing its own noise from
the run's seed: the points within rtol 1e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnc_tpu.cli.rd_sweep import main as j_main
from mmnc_tpu.entropy import entropy_bottleneck as j_eb
from mmnc_tpu.entropy import gaussian_conditional as j_gc
from mmnc_tpu.models import build_model as j_build_model

from mmnc_tpu_torch.cli import rd_sweep
from mmnc_tpu_torch.weights import state_dict_from_jax

ARGS = ["-d", "synthetic", "-t", "mono", "-m", "1", "-l", "8", "-c", "4",
        "-w", "sweeptest", "--lmbdas", "0.01", "--epochs", "1",
        "--batch-size", "2", "--train-size", "4", "--val-size", "2",
        "--max-steps", "2"]
NOISE = {"y": (2, 1, 1, 8), "z": (2, 1, 1, 4)}


def _noise():
    rng = np.random.default_rng(3)
    return {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for k, s in NOISE.items()}


def _assert_points(got, want, rtol, atol):
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    assert got[0]["lmbda"] == want[0]["lmbda"] == 0.01
    assert got[0]["step"] == want[0]["step"] == 2
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def test_sweep_matches_mmnc_tpu_from_the_same_weights(tmp_path, monkeypatch):
    jmodel = j_build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                           lmbda=0.01)
    # what JAX's fit initialises (the params depend on the batch's shape
    # only)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(21),
                                      jmodel.example_batch(2))["params"])
    noise = _noise()
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        want = j_main(ARGS + ["--out-dir", str(tmp_path / "jax")])

    build = rd_sweep.build_model

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(state_dict_from_jax(init))
        tensors = {k: torch.from_numpy(v) for k, v in noise.items()}
        model.draw_noise = lambda batch, generator: tensors
        return model

    monkeypatch.setattr(rd_sweep, "build_model", from_jax_init)
    got = rd_sweep.main(ARGS + ["--out-dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert got[0]["bpp"] > 0
    _assert_points(got, want, rtol=1e-3, atol=1e-4)
    sweep_dir = tmp_path / "port" / "sweeptest"
    with open(sweep_dir / "rd_points.json") as f:
        assert json.load(f) == got
    assert (sweep_dir / "rd_mono.png").stat().st_size > 0


def test_sweep_on_two_ranks_equals_one_process(tmp_path):
    before = torch.get_num_threads()
    torch.set_num_threads(2)  # one thread for each CPU rank
    try:
        points = {}
        for g in ("1", "2"):
            args = rd_sweep.parse_args(ARGS + [
                "--out-dir", str(tmp_path / g), "--device", "cpu", "-g", g])
            points[g] = rd_sweep.sweep(args)
    finally:
        torch.set_num_threads(before)
    _assert_points(points["2"], points["1"], rtol=1e-4, atol=0.0)
    sweep_dir = tmp_path / "2" / "sweeptest"
    assert os.path.exists(sweep_dir / "rd_points.json")
    assert not os.path.exists(sweep_dir / "rd_mono.png")  # sweep only
