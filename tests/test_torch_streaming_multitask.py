"""The port's streaming round trip (`models/streaming.py:stream_roundtrip`)
of the multi-task codecs on the CPU: mixed (model 2, m=8), disjoint
(model 3, m=6) and shared (model 4, m=8) at three tasks (rgb, depth,
semantic: widths 3/1/17), c = 4, 256 px, 2 batches of 2, both layouts
("v2" and "v1"). The params are the port's seed-0 init with its conv
kernels scaled (`weights.scale_conv_kernels`) plus 0.02 x N(0, 1) numpy
noise, carried to mmnc_tpu by its `import_reference_state_dict`
(`port_pair`), and the port codes on JAX's EB table (which may differ
from the port's by one count at a float32 tie; test_torch_entropy.py).
Torch runs 2 threads a test process here, as the tests share the host's
cores with other test processes.

Against mmnc_tpu's `stream_roundtrip` on the same params: the stream
bytes exactly equal, every task's x_hat within rtol 1e-3 / atol 1e-4
(tests/test_torch_import.py). Against the port's own packed compress /
decompress: the bytes equal, the x_hats within atol 1e-5
(tests/test_models.py). For the shared codec, a batch whose program
reports max_abs = 2^15 goes through the int32 fallback and still gives
compress()'s bytes and decompress()'s x_hats (tests/test_streaming.py
trips the guard by hand too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.models.streaming import stream_roundtrip as j_stream_roundtrip
from mmnc_tpu.utils.torch_import import import_reference_state_dict

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.models import streaming
from mmnc_tpu_torch.models.streaming import stream_roundtrip
from mmnc_tpu_torch.weights import scale_conv_kernels

from test_torch_multitask import CONFIGS, LMBDA, TASKS, use_jax_eb_table

N_BATCHES = 2


@pytest.fixture(autouse=True)
def two_threads():
    """Torch on 2 threads: the tests share the host's cores with other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def port_pair(variant):
    """(mmnc_tpu's codec, its {"params": ...}, the port codec) of
    CONFIGS[variant] at TASKS on one set of params: the port's seed-0
    init, conv kernels scaled, plus 0.02 x N(0, 1) noise."""
    number, m, c = CONFIGS[variant]
    port = scale_conv_kernels(build_model(number, TASKS, latent_channels=m,
                                          conv_channels=c, lmbda=LMBDA,
                                          device="cpu"))
    rng = np.random.default_rng(0)
    state_dict = {k: v + torch.from_numpy(
        0.02 * rng.normal(size=tuple(v.shape))).float()
        for k, v in port.state_dict().items()}
    port.load_state_dict(state_dict)
    jmodel = j_build_model(number, TASKS, latent_channels=m, conv_channels=c,
                           lmbda=LMBDA)
    return (jmodel, {"params": import_reference_state_dict(state_dict,
                                                           jmodel)}, port)


@pytest.fixture(scope="module")
def coded():
    """make_pair's results by variant, with both packages' tables built
    (the port's on JAX's EB table), and the batches, built once."""
    return {}


def _built(coded, variant):
    if variant not in coded:
        jmodel, variables, port = port_pair(variant)
        j_tables = jmodel.update_bottleneck_values(variables)
        use_jax_eb_table(port, j_tables)
        batches = [port.example_batch(2, seed=10 + s)
                   for s in range(N_BATCHES)]
        coded[variant] = (jmodel, variables, j_tables, port, batches)
    return coded[variant]


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, coded):
    return _built(coded, request.param)


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_multitask_stream_equals_mmnc_tpus_stream_and_its_own_codec(case,
                                                                    impl):
    jmodel, variables, j_tables, port, batches = case
    j_batches = [{t: jnp.asarray(x) for t, x in b.items()} for b in batches]
    want = list(j_stream_roundtrip(jmodel, variables, j_tables, j_batches,
                                   impl=impl))
    got = list(stream_roundtrip(port, batches, impl=impl))
    assert len(got) == len(want) == N_BATCHES
    for batch, (x_hats, n_bytes), (j_hats, j_bytes) in zip(batches, got,
                                                           want):
        assert set(x_hats) == set(port.tasks)
        assert n_bytes == j_bytes
        ans, n_ref = port.compress(batch)
        assert n_bytes == n_ref
        ref = port.decompress(ans)
        for task in port.tasks:
            np.testing.assert_allclose(x_hats[task].numpy(),
                                       np.asarray(j_hats[task]), rtol=1e-3,
                                       atol=1e-4, err_msg=task)
            np.testing.assert_allclose(x_hats[task].numpy(),
                                       ref[task].numpy(), atol=1e-5,
                                       err_msg=task)
    y_sym = port._compress_device_fused(batches[0])[0]
    assert (y_sym != 0).any()


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_shared_stream_int16_overflow_falls_back(monkeypatch, coded, impl):
    *_, port, batches = _built(coded, "shared")
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
    ref = port.decompress(ans)
    for task in port.tasks:
        np.testing.assert_allclose(x_hats[task].numpy(), ref[task].numpy(),
                                   atol=1e-5, err_msg=task)
