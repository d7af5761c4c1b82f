"""Data-parallel compress of the port
(`mmnc_tpu_torch.parallel.compress_device_fused_sharded`, `Mesh.all_gather`)
on the CPU: ranks are processes over gloo, started by `parallel.launch`.

The shared codec at three tasks (test_torch_streaming_multitask.py's
`port_pair`: rgb, depth, semantic, m=8, c=4, the port's init with its
kernels scaled and plus numpy noise, as JAX params too) compresses a
global batch of 4 at 256 px on 2 ranks (2 rows each). The gathered int16
symbols, uint8 indexes and max_abs are bitwise equal to one process's
`_compress_device_fused` and to mmnc_tpu's, and the rANS streams coded
from them are the bytes of one process's packed `compress`.
`Mesh.all_gather` returns every rank's tensor in rank order, bit for bit,
for each dtype the programs give (it moves bytes).

The rank functions are module-level (spawned ranks import this module),
and this module imports JAX only inside the fixture that runs it.
"""

import numpy as np
import pytest
import torch

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.entropy import rans
from mmnc_tpu_torch.parallel import compress_device_fused_sharded, launch

TASKS = ("rgb", "depth_euclidean", "semantic")
NUMBER, LATENT, CONV = 4, 8, 4
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


def _model(state_dict):
    model = build_model(NUMBER, TASKS, latent_channels=LATENT,
                        conv_channels=CONV, lmbda=1e-2, device="cpu")
    model.load_state_dict(state_dict)
    return model


def _sharded(mesh, state_dict, batch):
    outs = compress_device_fused_sharded(_model(state_dict), batch, mesh)
    return [t.numpy() for t in outs]


@pytest.fixture(scope="module")
def case():
    """The port's shared codec on JAX's params, a global batch, and
    mmnc_tpu's fused compress of it."""
    import jax

    from test_torch_streaming_multitask import port_pair

    jmodel, variables, port = port_pair("shared")
    batch = port.example_batch(GLOBAL_BATCH, seed=4)
    j_outs = jax.device_get(jmodel._compress_device_fused(
        variables, {t: jax.numpy.asarray(x) for t, x in batch.items()}))
    return {"state_dict": port.state_dict(), "batch": batch,
            "jax": [np.asarray(t) for t in j_outs]}


def test_two_rank_compress_equals_one_process_and_mmnc_tpu(case):
    ranks = launch(_sharded, 2, "cpu", case["state_dict"], case["batch"],
                   timeout=TIMEOUT)
    model = _model(case["state_dict"])
    single = [t.numpy() for t in model._compress_device_fused(case["batch"])]
    for got in ranks:
        assert len(got) == len(single) == len(case["jax"]) == 4
        for name, g, s, j in zip(("y", "z", "indexes", "max_abs"), got,
                                 single, case["jax"]):
            assert g.dtype == s.dtype and g.shape == s.shape, name
            np.testing.assert_array_equal(g, s, err_msg=name)
            np.testing.assert_array_equal(g, j, err_msg=f"{name} vs JAX")
    y_sym, z_sym, indexes, _ = ranks[0]
    assert y_sym.shape[0] == GLOBAL_BATCH and (y_sym != 0).any()

    tables = model.update_bottleneck_values()
    b, zh, zw, _ = z_sym.shape
    ys = rans.encode_with_indexes(y_sym, indexes, tables.gc)
    zs = rans.encode_with_indexes(z_sym, model._z_index((b, zh, zw)),
                                  tables.eb)
    ans, n_bytes = model.compress(case["batch"])
    assert ans["strings"] == [[ys], [zs]]
    assert len(ys) + len(zs) == n_bytes


def _gather(mesh):
    r = mesh.rank
    values = {
        "int16": torch.tensor([[-3 - r, 2 ** 15 - 1 - r]], dtype=torch.int16),
        "uint8": torch.full((2, 3), 250 + r, dtype=torch.uint8),
        "int32": torch.tensor([7 * r - 2 ** 31 + 5], dtype=torch.int32),
        "float32": torch.tensor([[1.5, -0.0, float(r) / 3]]),
    }
    return {k: mesh.all_gather(v).numpy() for k, v in values.items()}


def test_all_gather_moves_every_dtype_bit_for_bit_in_rank_order():
    ranks = launch(_gather, 2, "cpu", timeout=TIMEOUT)
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    got = ranks[0]
    np.testing.assert_array_equal(
        got["int16"], np.array([[-3, 32767], [-4, 32766]], np.int16))
    np.testing.assert_array_equal(
        got["uint8"], np.concatenate([np.full((2, 3), 250, np.uint8),
                                      np.full((2, 3), 251, np.uint8)]))
    np.testing.assert_array_equal(
        got["int32"], np.array([-2 ** 31 + 5, -2 ** 31 + 12], np.int32))
    assert got["float32"].view(np.uint32).tolist() == np.array(
        [[1.5, -0.0, 0.0], [1.5, -0.0, np.float32(1) / np.float32(3)]],
        np.float32).view(np.uint32).tolist()
