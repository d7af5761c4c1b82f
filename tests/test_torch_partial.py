"""Partial coding and the bitstream container of the port against mmnc_tpu
on the CPU, for the disjoint and shared codecs of test_torch_multitask.py
(rgb, depth, semantic at 256 px, batch 2; JAX's params carried across).

Every stream is coded on JAX's tables (the EB table may differ by one
count, test_torch_entropy.py), so slice streams and container files are
held byte-equal to mmnc_tpu's. Decodes: within rtol 1e-3 / atol 1e-4 of
JAX's (tests/test_torch_import.py), and a task subset within atol 1e-5
of the port's full decode (tests/test_models.py), exactly equal where
the same streams go through the same port code."""

import os

import numpy as np
import pytest

from mmnc_tpu import bitstream as j_bitstream

from mmnc_tpu_torch import bitstream, build_model
from mmnc_tpu_torch.entropy import rans
from test_torch_multitask import (BATCH, TASKS, jax_batch, make_pair,
                                  use_jax_eb_table)

SUBSETS = [["rgb"], ["semantic", "depth_euclidean"], list(TASKS)]


@pytest.fixture(scope="module", params=["disjoint", "shared"])
def coded(request):
    """The pair on JAX's tables with both packages' packed partial and
    full codes of the same batch."""
    jmodel, variables, port, batch = make_pair(request.param)
    j_tables = jmodel.update_bottleneck_values(variables)
    use_jax_eb_table(port, j_tables)
    jb = jax_batch(batch)
    return {
        "jmodel": jmodel, "variables": variables, "j_tables": j_tables,
        "port": port, "batch": batch,
        "partial": port.compress_partial(batch),
        "j_partial": jmodel.compress_partial(variables, j_tables, jb),
        "full": port.compress(batch)[0],
        "j_full": jmodel.compress(variables, j_tables, jb)[0],
    }


def _close(got, want, tasks):
    assert sorted(got) == sorted(tasks)
    for task in tasks:
        np.testing.assert_allclose(np.asarray(got[task]),
                                   np.asarray(want[task]), rtol=1e-3,
                                   atol=1e-4, err_msg=task)


def test_compress_partial_streams_equal_to_jax(coded):
    port = coded["port"]
    ans, total = coded["partial"]
    j_ans, j_total = coded["j_partial"]
    assert total == j_total
    assert ans == j_ans
    names = [name for name, _, _ in port.variant_slices()]
    assert list(ans["task_streams"]) == names
    assert ("shared" in names) == (port.variant == "shared")
    assert all(len(s) == 1 for s in ans["task_streams"].values())


@pytest.mark.parametrize("tasks", SUBSETS, ids=lambda t: "+".join(t))
def test_decompress_tasks_matches_jax_and_full_decode(coded, tasks):
    port = coded["port"]
    got = port.decompress_tasks(coded["partial"][0], tasks)
    want = coded["jmodel"].decompress_tasks(
        coded["variables"], coded["j_tables"], coded["j_partial"][0], tasks)
    _close(got, want, tasks)
    full = port.decompress(coded["full"])
    for task in tasks:
        np.testing.assert_allclose(got[task].numpy(), full[task].numpy(),
                                   atol=1e-5, err_msg=task)


def test_decompress_tasks_takes_per_image_slice_streams(coded):
    """One stream per image for every slice and for z (the reference's
    per-item layout): the same decode as the packed streams."""
    port, tables = coded["port"], coded["port"].tables
    y_sym, z_sym, indexes = (x.contiguous().numpy()
                             for x in port._compress_device(coded["batch"]))
    zc = z_sym.shape[-1]
    z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32), z_sym.shape[1:])
    ans = dict(coded["partial"][0])
    ans["task_streams"] = {
        name: [rans.encode_with_indexes(y_sym[i, ..., lo:hi],
                                        indexes[i, ..., lo:hi], tables.gc)
               for i in range(BATCH)]
        for name, lo, hi in port.variant_slices()}
    ans["z_strings"] = [rans.encode_with_indexes(z_sym[i], z_idx, tables.eb)
                        for i in range(BATCH)]
    tasks = ["semantic", "rgb"]
    got = port.decompress_tasks(ans, tasks)
    packed = port.decompress_tasks(coded["partial"][0], tasks)
    for task in tasks:
        np.testing.assert_array_equal(got[task].numpy(), packed[task].numpy())
    want = coded["jmodel"].decompress_tasks(coded["variables"],
                                            coded["j_tables"], ans, tasks)
    _close(got, want, tasks)


@pytest.mark.parametrize("partial", [True, False])
def test_container_files_equal_to_jax_and_decode(coded, partial, tmp_path):
    """The port writes the bytes mmnc_tpu's save_bitstream writes for its
    own code of the batch, reads them back, and decodes the file to what
    it decodes without it (partial: a task subset too)."""
    port, jmodel = coded["port"], coded["jmodel"]
    key = "partial" if partial else "full"
    ans = coded[key][0] if partial else coded[key]
    j_ans = coded["j_" + key][0] if partial else coded["j_" + key]
    path, j_path = tmp_path / "port.mmnc", tmp_path / "jax.mmnc"
    bitstream.save_bitstream(str(path), ans, port.hyper_parameters, partial)
    j_bitstream.save_bitstream(str(j_path), j_ans, jmodel.hyper_parameters,
                               partial)
    assert path.read_bytes() == j_path.read_bytes()
    loaded, header = bitstream.load_bitstream(str(path))
    assert loaded == ans
    assert header["partial"] is partial
    assert header["hyper_parameters"] == port.hyper_parameters
    direct = (port.decompress_tasks(ans, list(TASKS)) if partial
              else port.decompress(ans))
    from_file = bitstream.decompress_file(str(path), port)
    for task in TASKS:
        np.testing.assert_array_equal(from_file[task].numpy(),
                                      direct[task].numpy())
    if partial:
        subset = bitstream.decompress_file(str(path), port, ["depth_euclidean"])
        np.testing.assert_array_equal(subset["depth_euclidean"].numpy(),
                                      direct["depth_euclidean"].numpy())
    else:
        with pytest.raises(ValueError, match="partial container"):
            bitstream.decompress_file(str(path), port, ["rgb"])


@pytest.mark.parametrize("partial", [True, False])
def test_port_decodes_jax_written_container(coded, partial, tmp_path):
    """A container mmnc_tpu wrote, decoded by the port: equal to JAX's own
    decode of it, and the port's loader reads what JAX's loader reads."""
    port, jmodel = coded["port"], coded["jmodel"]
    key = "partial" if partial else "full"
    j_ans = coded["j_" + key][0] if partial else coded["j_" + key]
    path = os.path.join(tmp_path, "jax.mmnc")
    j_bitstream.save_bitstream(path, j_ans, jmodel.hyper_parameters, partial)
    assert bitstream.load_bitstream(path) == j_bitstream.load_bitstream(path)
    tasks = ["semantic", "rgb"] if partial else None
    got = bitstream.decompress_file(path, port, tasks)
    want = j_bitstream.decompress_file(path, jmodel, coded["variables"],
                                       coded["j_tables"], tasks)
    _close(got, want, tasks or list(TASKS))


def test_partial_coding_needs_a_separable_latent(tmp_path):
    """A mixed codec has no slices to code apart; an unknown task and a
    file that is no container are refused."""
    mixed = build_model(2, TASKS, 8, 4, device="cpu")
    mixed.update_bottleneck_values()
    batch = mixed.example_batch(1)
    with pytest.raises(ValueError, match="disjoint or shared"):
        mixed.compress_partial(batch)
    shared = build_model(4, TASKS, 8, 4, device="cpu")
    shared.update_bottleneck_values()
    ans, _ = shared.compress_partial(batch)
    with pytest.raises(ValueError, match="unknown tasks"):
        shared.decompress_tasks(ans, ["normal"])
    path = tmp_path / "not.mmnc"
    path.write_bytes(b"JUNK" + bytes(8))
    with pytest.raises(ValueError, match="not an MMNC bitstream"):
        bitstream.load_bitstream(str(path))
