"""The ported serving slice against mmnc_tpu on the CPU: the single-task
rgb codec (c=4, m=8 at 256 px, the geometry test_torch_import.py uses)
with JAX params carried over by `state_dict_from_jax`.

Floats agree at the tolerance of test_torch_import.py (rtol 1e-3,
atol 1e-4); symbols, indexes and stream bytes are exactly equal; the
port's decode equals its own eval forward at tests/test_models.py's
atol 1e-5."""

import hashlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.utils.torch_import import import_reference_state_dict

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.entropy.tables import CdfTable
from mmnc_tpu_torch.weights import state_dict_from_jax


def _kernel_gain(path):
    """At init scale every y rounds to 0 and the decode is all zeros, so
    the conv kernels are scaled (encoder 4, hyper 10, decoder 3) to give
    non-zero y and z symbols, spread indexes and an O(1) reconstruction."""
    keys = [getattr(p, "key", None) for p in path]
    if keys[-1] != "kernel":
        return 1.0
    if "h_a" in keys or "h_s" in keys:
        return 10.0
    if "g_s" in keys or "output_heads_0" in keys:
        return 3.0
    return 4.0


@pytest.fixture(scope="module")
def pair():
    """A JAX codec with its init params, scaled and plus numpy noise (so
    GDN and the EB medians are not at their init values), and the port
    carrying them."""
    jmodel = j_build_model(1, ["rgb"], latent_channels=8, conv_channels=4)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * _kernel_gain(path)
                         + 0.02 * rng.normal(size=v.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    port = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                       device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    return jmodel, {"params": params}, port


@pytest.fixture(scope="module")
def batch():
    return {"rgb": np.random.default_rng(1).random(
        (2, 256, 256, 3)).astype(np.float32)}


def test_importer_recovers_jax_params_from_port_state_dict(pair):
    jmodel, variables, port = pair
    back = import_reference_state_dict(port.state_dict(), jmodel)
    want = variables["params"]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path])


def test_eval_forward_and_likelihoods_match_jax(pair, batch):
    jmodel, variables, port = pair
    j_hats, j_lik = jmodel.forward(variables, {"rgb": jnp.asarray(batch["rgb"])},
                                   training=False)
    t_hats, t_lik = port(batch)
    assert t_hats["rgb"].shape == (2, 256, 256, 3)
    np.testing.assert_allclose(t_hats["rgb"].numpy(), np.asarray(j_hats["rgb"]),
                               rtol=1e-3, atol=1e-4)
    for key, shape in (("y", (2, 4, 4, 8)), ("z", (2, 1, 1, 4))):
        assert t_lik[key].shape == shape
        np.testing.assert_allclose(t_lik[key].numpy(), np.asarray(j_lik[key]),
                                   rtol=1e-3, atol=1e-4)


def test_symbols_and_indexes_equal_to_jax(pair, batch):
    jmodel, variables, port = pair
    want = jax.device_get(jmodel._compress_device(
        variables, {"rgb": jnp.asarray(batch["rgb"])}))
    got = [x.contiguous().numpy() for x in port._compress_device(batch)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    y_sym, z_sym, indexes = got
    assert (y_sym != 0).any() and (z_sym != 0).any()
    assert len(np.unique(indexes)) > 1


def test_stream_bytes_equal_to_jax_on_jax_tables(pair, batch):
    """Same symbols + the same tables -> the same bytes. The EB table is
    JAX's (see test_torch_entropy.py for why it can differ by one count);
    the Gaussian table is the port's own, which equals JAX's exactly."""
    jmodel, variables, port = pair
    j_tables = jmodel.update_bottleneck_values(variables)
    tables = port.update_bottleneck_values()
    np.testing.assert_array_equal(tables.gc.cdfs, j_tables.gc.cdfs)
    np.testing.assert_array_equal(tables.eb_medians, j_tables.eb_medians)
    tables.eb = CdfTable(cdfs=j_tables.eb.cdfs,
                         cdf_lengths=j_tables.eb.cdf_lengths,
                         offsets=j_tables.eb.offsets)
    for packed in (True, False):
        j_ans, j_n = jmodel.compress(variables, j_tables,
                                     {"rgb": jnp.asarray(batch["rgb"])},
                                     packed=packed)
        ans, n = port.compress(batch, packed=packed)
        assert n == j_n
        assert ans["strings"] == j_ans["strings"]
        assert (ans["shape"], ans["y_shape"], ans["batch_size"]) == (
            j_ans["shape"], j_ans["y_shape"], j_ans["batch_size"])


@pytest.mark.parametrize("packed", [True, False])
def test_decode_equals_own_eval_forward(pair, batch, packed):
    _, _, port = pair
    port.update_bottleneck_values()
    ref, _ = port(batch)
    ans, n_bytes = port.compress(batch, packed=packed)
    assert n_bytes > 0
    assert len(ans["strings"][0]) == (1 if packed else 2)
    out = port.decompress(ans)
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"].numpy(),
                               atol=1e-5)


def test_compress_needs_tables():
    port = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                       device="cpu")
    with pytest.raises(RuntimeError):
        port.compress({"rgb": np.zeros((1, 256, 256, 3), np.float32)})


# sha256 over (name, float32 bytes) of every state_dict entry, in order, of
# build_model(1, ["rgb"], m, c, seed=0), taken on the tree before the
# four-variant codecs: the single-task model still draws these weights
SEED0_SHA256 = {
    (8, 4): "a8353dae390a78ae79d1e9ff91299f9faac5eaecc5dd776aaf6234bd2bb66718",
    (128, 100): "19f40059ff4e1d27213df83e02c28e63137bdfda5e6762ddfc963aa970b5cdaf",
}


def _state_sha256(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_same_seed_same_weights_and_unported_models_raise():
    """The same seed draws the same weights and another seed others; the
    single-task model from seed 0 draws the weights it drew before the
    multi-task variants came in; an unknown model number or name raises,
    as do two tasks for the single-task model."""
    a = build_model(1, ["rgb"], 8, 4, device="cpu", seed=5)
    b = build_model(1, ["rgb"], 8, 4, device="cpu", seed=5)
    c = build_model(1, ["rgb"], 8, 4, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.input_heads.0.0.weight"],
                           sc["model.input_heads.0.0.weight"])
    for (m, conv), want in SEED0_SHA256.items():
        assert _state_sha256(build_model(1, ["rgb"], m, conv, device="cpu",
                                         seed=0)) == want
    for unknown in (5, 0, "MultiTaskUnknownCompressor"):
        with pytest.raises(ValueError, match="unknown model"):
            build_model(unknown, ["rgb"], 8, 4, device="cpu")
    with pytest.raises(ValueError):
        build_model(1, ["rgb", "rgb"], 8, 4, device="cpu")


def test_entry_points_raise_without_a_card_and_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(1, ["rgb"], latent_channels=8, conv_channels=4)
