"""The port's streaming round trip (mmnc_tpu_torch/models/streaming.py) on
the CPU, against its own packed compress/decompress and against the JAX
package's stream_roundtrip: the single-task rgb codec at c=4, m=8, 256 px
with JAX params carried over by `state_dict_from_jax` (the geometry of
tests/test_torch_codec.py).

Stream bytes are exactly equal; x_hats equal the port's own decompress at
tests/test_models.py's atol 1e-5 and the JAX package's at
tests/test_torch_import.py's rtol 1e-3 / atol 1e-4. The device programs
are bitwise equal to each other. Everything runs through the plain
versions of the kernels (CPU tensors)."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.models.streaming import stream_roundtrip as j_stream_roundtrip

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.entropy.tables import CdfTable
from mmnc_tpu_torch.models import streaming
from mmnc_tpu_torch.models.streaming import stream_roundtrip
from mmnc_tpu_torch.weights import state_dict_from_jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_gain(path):
    """Conv kernels scaled (encoder 4, hyper 10, decoder 3), as in
    tests/test_torch_codec.py, so y and z have non-zero symbols."""
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
    """The JAX codec, its scaled and perturbed params, its tables, and the
    port carrying the same params with JAX's EB table (which may differ
    from the port's by one count at a float32 tie; tests/test_torch_entropy.py)."""
    jmodel = j_build_model(1, ["rgb"], latent_channels=8, conv_channels=4)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jmodel.example_batch(image_size=256))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) * _kernel_gain(path)
                         + 0.02 * rng.normal(size=v.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    variables = {"params": params}
    j_tables = jmodel.update_bottleneck_values(variables)
    port = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                       device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    port.update_bottleneck_values()
    port.tables.eb = CdfTable(cdfs=j_tables.eb.cdfs,
                              cdf_lengths=j_tables.eb.cdf_lengths,
                              offsets=j_tables.eb.offsets)
    return jmodel, variables, j_tables, port


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(1)
    return [{"rgb": rng.random((2, 256, 256, 3)).astype(np.float32)}
            for _ in range(3)]


@pytest.mark.parametrize("depth,coder_threads", [(3, 2), (1, 1)])
@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_stream_equals_packed_compress_and_decompress(pair, batches, impl,
                                                      depth, coder_threads):
    *_, port = pair
    streamed = list(stream_roundtrip(port, batches, depth=depth,
                                     coder_threads=coder_threads, impl=impl))
    assert len(streamed) == len(batches)
    for batch, (x_hats, n_bytes) in zip(batches, streamed):
        ans, n_ref = port.compress(batch)
        assert n_bytes == n_ref
        ref = port.decompress(ans)
        assert x_hats["rgb"].shape == (2, 256, 256, 3)
        np.testing.assert_allclose(x_hats["rgb"].numpy(), ref["rgb"].numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_stream_equals_the_jax_packages_stream(pair, batches, impl):
    jmodel, variables, j_tables, port = pair
    j_batches = [{"rgb": jnp.asarray(b["rgb"])} for b in batches]
    want = list(j_stream_roundtrip(jmodel, variables, j_tables, j_batches,
                                   impl=impl))
    got = list(stream_roundtrip(port, batches, impl=impl))
    for (x_hats, n_bytes), (j_hats, j_bytes) in zip(got, want):
        assert n_bytes == j_bytes
        np.testing.assert_allclose(x_hats["rgb"].numpy(),
                                   np.asarray(j_hats["rgb"]),
                                   rtol=1e-3, atol=1e-4)


def test_fused_program_equals_lean_plus_indexes_bitwise(pair, batches):
    """The v2 program's symbols, u8 indexes and max_abs are the v1 pair's
    (`_compress_device_lean` + `_decompress_indexes_u8` on the same z)."""
    *_, port = pair
    y1, z1, max1 = port._compress_device_lean(batches[0])
    idx1 = port._decompress_indexes_u8(z1, tuple(y1.shape[1:3]))
    y2, z2, idx2, max2 = port._compress_device_fused(batches[0])
    assert (y2.dtype, z2.dtype, idx2.dtype, max2.dtype) == (
        torch.int16, torch.int16, torch.uint8, torch.int32)
    for a, b in ((y1, y2), (z1, z2), (idx1, idx2), (max1, max2)):
        assert torch.equal(a, b)
    assert (y2 != 0).any() and (z2 != 0).any()
    # the classic program's symbols and indexes, narrowed
    y, z, idx = port._compress_device(batches[0])
    assert torch.equal(y.to(torch.int16), y2) and torch.equal(z.to(torch.int16), z2)
    assert torch.equal(idx.to(torch.uint8), idx2)
    assert int(max2) == max(y.abs().max().item(), z.abs().max().item())


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_stream_int16_overflow_falls_back(monkeypatch, pair, batches, impl):
    """A max_abs of 2^15 sends the batch down the int32 path, which still
    gives compress()'s bytes and decompress()'s x_hats (GDN keeps real
    inputs far from 2^15, so the guard is tripped by hand, as in
    tests/test_streaming.py)."""
    *_, port = pair
    name = ("_compress_device_fused" if impl == "v2"
            else "_compress_device_lean")
    program = getattr(port, name)
    wide = []

    def tripped(batch):
        *outs, _ = program(batch)
        return (*outs, torch.tensor(2 ** 15, dtype=torch.int32))

    def counted(pipe, batch):
        wide.append(batch)
        return real_wide(pipe, batch)

    real_wide = streaming._roundtrip_one_wide
    monkeypatch.setattr(port, name, tripped)
    monkeypatch.setattr(streaming, "_roundtrip_one_wide", counted)
    (x_hats, n_bytes), = list(stream_roundtrip(port, batches[:1], impl=impl))
    assert len(wide) == 1
    ans, n_ref = port.compress(batches[0])
    assert n_bytes == n_ref
    np.testing.assert_allclose(x_hats["rgb"].numpy(),
                               port.decompress(ans)["rgb"].numpy(), atol=1e-5)


def test_stream_refuses_an_unknown_impl(pair, batches):
    *_, port = pair
    with pytest.raises(ValueError):
        list(stream_roundtrip(port, batches, impl="v3"))


@pytest.mark.parametrize("threads", [None, 1])
def test_bench_prints_one_json_line_on_the_cpu(threads):
    """With stream_roundtrip's own coder threads, and with one given."""
    flag = [] if threads is None else ["--coder-threads", str(threads)]
    out = subprocess.run(
        [sys.executable, "-m", "mmnc_tpu_torch.bench", "--device", "cpu",
         "--batch", "1", "--iters", "1", "--latent", "8", "--conv", "4"]
        + flag, cwd=_ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result["mps_by_stream_impl"]) == {"v2", "v1"}
    assert result["value"] == max(result["mps_by_stream_impl"].values()) > 0
    assert result["stream_impl"] in ("v2", "v1")
    assert (result["batch_size"], result["iters"], result["precision"]) == (
        1, 1, "f32")
    assert result["bytes_per_image"] > 0
    assert result["mps_compress_decompress"] > 0
    assert result["coder_threads"] == (threads or inspect.signature(
        stream_roundtrip).parameters["coder_threads"].default)
    assert result["device"] == "cpu" and result["card"] is None
