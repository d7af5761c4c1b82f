"""The port's analysis toolkit (`mmnc_tpu_torch.analysis`) against
`mmnc_tpu.analysis` on the CPU.

One set of weights for both packages: JAX's init params of the disjoint
codec (rgb + mono, m=8, c=4 at 256 px) with the conv kernels scaled so y
and z are not all zero, carried over by `state_dict_from_jax`; one numpy
batch of 2. Stream bytes and symbol counts exactly equal; check_bpp's
estimates within rtol 1e-4; per-channel bpp, latents and decodes within
rtol 1e-3 / atol 1e-4 (tests/test_torch_import.py's float tolerance).
`learned_baseline_rd` over one checkpoint written by each package from
the same params. The RD-point reader, the plot and both classical codecs
as tests/test_analysis.py runs them, against mmnc_tpu's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnc_tpu import analysis as j_analysis
from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.train import create_train_state as j_create_train_state
from mmnc_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

from mmnc_tpu_torch import analysis, build_model
from mmnc_tpu_torch.train import create_train_state
from mmnc_tpu_torch.utils.checkpoint import save_checkpoint
from mmnc_tpu_torch.weights import state_dict_from_jax

from test_torch_multitask import kernel_gain, use_jax_eb_table

TASKS = ("rgb", "mono")
RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(JAX codec, {"params": scaled params}, JAX's coding tables, the port
    codec carrying the params and JAX's EB table, a numpy batch of 2)."""
    jmodel = j_build_model(3, TASKS, latent_channels=8, conv_channels=4,
                           lmbda=1e-2)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * kernel_gain(path)).astype(
            np.float32), jax.device_get(variables["params"]))
    variables = {"params": params}
    tables = jmodel.update_bottleneck_values(variables)
    port = build_model(3, TASKS, latent_channels=8, conv_channels=4,
                       lmbda=1e-2, device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    use_jax_eb_table(port, tables)
    return jmodel, variables, tables, port, jmodel.example_batch(2, seed=1)


def _jax(batch):
    return {t: jnp.asarray(x) for t, x in batch.items()}


def test_rd_point_extraction_matches_jax(tmp_path):
    path = tmp_path / "m.jsonl"
    rows = [
        {"step": 1, "train/loss": 5.0},
        {"step": 2, "val/compression_loss": 0.5, "val/rgb/psnr": 30.0,
         "val/rgb/ms-ssim": 0.9},
        {"step": 4, "val/compression_loss": 0.4, "val/rgb/psnr": 31.0,
         "val/rgb/ms-ssim": 0.95},
    ]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    pt = analysis.final_rd_point(str(path), ["rgb"])
    assert pt == j_analysis.final_rd_point(str(path), ["rgb"])
    assert pt["bpp"] == 0.4 and pt["rgb/psnr"] == 31.0
    assert analysis.load_metrics(str(path)) == rows
    with pytest.raises(ValueError, match="no test records"):
        analysis.final_rd_point(str(path), ["rgb"], prefix="test")


def test_plot_rd_curves(tmp_path):
    pts = {"mixed": [{"bpp": 0.1, "rgb/psnr": 30},
                     {"bpp": 0.3, "rgb/psnr": 34}],
           "disjoint": [{"bpp": 0.15, "rgb/psnr": 29}]}
    out = tmp_path / "rd.png"
    fig = analysis.plot_rd_curves(pts, "rgb", out_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    assert [line.get_label() for line in fig.axes[0].lines] == list(pts)


@pytest.mark.parametrize("codec", ["JPEG", "WEBP"])
def test_classical_codec_bisection_matches_jax(codec):
    rng = np.random.default_rng(0)
    img = rng.random((128, 128, 3)).astype(np.float32)
    decoded, bpp, q = analysis.classical_codec_rd(img, target_bpp=1.0,
                                                  codec=codec, tol=0.2)
    j_decoded, j_bpp, j_q = j_analysis.classical_codec_rd(
        img, target_bpp=1.0, codec=codec, tol=0.2)
    assert decoded.shape == (128, 128, 3)
    assert 1 <= q <= 100 and bpp > 0
    assert (bpp, q) == (j_bpp, j_q)
    np.testing.assert_array_equal(decoded, j_decoded)


def test_check_bpp_matches_jax(pair):
    jmodel, variables, tables, port, batch = pair
    want = j_analysis.check_bpp(jmodel, variables, tables, _jax(batch))
    got = analysis.check_bpp(port, batch)
    assert got["bytes"] == want["bytes"] > 0
    assert got["actual_bpp"] == want["actual_bpp"] > 0
    for k in ("estimated_bpp", "estimated_bpp_legacy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # the legacy geometry counts a saturated y value 16x
    assert got["estimated_bpp_legacy"] > got["estimated_bpp"] > 0


def test_channel_bpp_matches_jax(pair):
    jmodel, variables, _, port, batch = pair
    want = j_analysis.channel_bpp(jmodel, variables, batch)
    got = analysis.channel_bpp(port, batch)
    assert got["y"].shape == (port.latent_channels,)
    assert got["z"].shape == want["z"].shape
    assert np.all(got["y"] >= 0)
    for name in ("y", "z"):
        _close(got[name], want[name], name)
    assert got["task_slices"] == list(want["task_slices"]) == [
        ("rgb", 0, 4), ("mono", 4, 8)]


def test_encode_eval_symbols_equal_jax(pair):
    """The latents the probes edit: y and z symbols equal, some y non-zero."""
    jmodel, variables, _, port, batch = pair
    jy, jz = jmodel.encode_eval(variables, _jax(batch))
    y, z = port.encode_eval(batch)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert (y != 0).any()


def test_swap_latent_slices_matches_jax(pair):
    jmodel, variables, _, port, batch = pair
    batch_b = jmodel.example_batch(2, seed=7)
    channels = range(0, port.channels_per_task)
    want = j_analysis.swap_latent_slices(jmodel, variables, _jax(batch),
                                         _jax(batch_b), channels)
    got = analysis.swap_latent_slices(port, batch, batch_b, channels)
    assert set(got) == set(want) == set(TASKS)
    for t in TASKS:
        _close(got[t].numpy(), want[t], t)


@pytest.mark.parametrize("channels", [[0, 1], [3, 4, 7]])
def test_average_channels_matches_jax(pair, channels):
    jmodel, variables, _, port, batch = pair
    want = j_analysis.average_channels(jmodel, variables, _jax(batch),
                                       channels)
    got = analysis.average_channels(port, batch, channels)
    assert set(got) == set(want) == set(TASKS)
    for t in TASKS:
        _close(got[t].numpy(), want[t], t)


def test_latent_slice_separability(pair):
    """Disjoint separability, as tests/test_analysis.py probes it: moving
    rgb's y slice changes only rgb's reconstruction."""
    _, _, _, port, batch = pair
    y, z = port.encode_eval(batch)
    y_pert = y.clone()
    y_pert[..., :port.channels_per_task] += 5.0
    base = port.decode_from_latents(y, z)
    pert = port.decode_from_latents(y_pert, z)
    assert (pert["mono"] - base["mono"]).abs().max().item() == 0.0
    assert (pert["rgb"] - base["rgb"]).abs().max().item() > 0.0


@pytest.fixture(scope="module")
def checkpoints(pair, tmp_path_factory):
    """The pair's params saved by each package as step_3 of its own run."""
    jmodel, variables, _, port, _ = pair
    root = tmp_path_factory.mktemp("ckpts")
    hp = {**jmodel.hyper_parameters, "total_steps": 10}
    j_path = j_save_checkpoint(
        str(root / "jax"), 3, j_create_train_state(variables["params"], 10),
        hp)
    t_path = save_checkpoint(str(root / "port"), 3, port,
                             create_train_state(port, 10), hp)
    return j_path, t_path


@pytest.mark.parametrize("explicit_batch", [False, True],
                         ids=["held_out_images", "one_batch"])
def test_learned_baseline_rd_matches_jax(pair, checkpoints, monkeypatch,
                                         explicit_batch):
    """Over 4 held-out images in batches of 2 (the two batches' mean), or
    on the pair's batch. The port rebuilds its tables from the checkpoint;
    its EB table is JAX's where the two differ by a count
    (test_torch_entropy.py), so the bytes compare."""
    jmodel, variables, tables, port, batch = pair
    j_path, t_path = checkpoints
    cls = type(port)
    build = cls.update_bottleneck_values

    def with_jax_eb_table(self):
        built = build(self)
        built.eb = port.tables.eb
        return built

    monkeypatch.setattr(cls, "update_bottleneck_values", with_jax_eb_table)
    kw = ({"batch": batch} if explicit_batch
          else {"n_images": 4, "batch_size": 2})
    (want,) = j_analysis.learned_baseline_rd([j_path], **kw)
    (got,) = analysis.learned_baseline_rd([t_path], device="cpu", **kw)
    assert set(got) == set(want)
    assert got["n_images"] == want["n_images"] == (2 if explicit_batch
                                                   else 4)
    assert got["bytes"] == want["bytes"] > 0
    assert got["actual_bpp"] == got["bpp"] == want["bpp"]
    assert got["lmbda"] == want["lmbda"] == 1e-2
    assert got["checkpoint"] == t_path
    for k in ("estimated_bpp", "estimated_bpp_legacy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for t in TASKS:
        for m in ("psnr", "ms-ssim"):
            _close(got[f"{t}/{m}"], want[f"{t}/{m}"], f"{t}/{m}")


def test_learned_baseline_rd_without_a_card_or_device_raises(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis.learned_baseline_rd([checkpoints[1]], n_images=2,
                                     batch_size=2)
