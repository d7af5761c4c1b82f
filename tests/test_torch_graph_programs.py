"""The port's device programs as CUDA graphs (`mmnc_tpu_torch/graphs.py`),
checked on the CPU.

On a card each no-grad device program of a codec (the eval forward,
`encode_eval`, the three compress programs, the index and synthesis
programs, the partial decode's `_synthesize_task`) and the eval step run
as CUDA graphs: a warm-up call, a capture, then replays. On the CPU they
run eagerly, so these tests hold what a graph records, and the host side
of the graph path, to their references:

* each program's capture body (run with `graphs.capturing` patched, so
  `ops/layers.py:_derived` derives its tensors anew and caches nothing,
  as it does while a stream captures) equals the eager program with its
  derived tensors cached, bitwise, and mmnc_tpu's jitted program of the
  same name on the same weights: integers (symbols, indexes, max_abs,
  rounded latents) exactly, floats within rtol 1e-3 / atol 1e-4
  (tests/test_torch_import.py), the eval step's logs within rtol 1e-4
  (tests/test_torch_train.py);
* the graph cache on a fake card, whose capture records the body and
  whose replay runs it again in capturing mode into the static outputs:
  warm-up, capture, replay; the same signature reuses its graph; a new
  batch size, input type, `y_shape`, `task_index` or cuDNN flag warms up
  anew; an in-place parameter update and a `load_state_dict` do not, and
  the replay then equals the eager program on the new parameters; the
  bound drops the least recently used signature; outputs of two calls
  never alias; `graphs.disabled()` runs eagerly; a failed capture raises;
* `stream_roundtrip` (v2 and v1) and the eval step through the fake
  graphs: stream bytes equal `compress(packed=True)`'s and mmnc_tpu's
  stream's, the x_hats mmnc_tpu's at rtol 1e-3 / atol 1e-4, the eval
  logs mmnc_tpu's `make_eval_step`'s at rtol 1e-4.

Models: the mono codec (m=8, c=4, model 1) and the shared codec of three
tasks (rgb, depth, semantic; m=8, c=4, model 4, as
tests/test_torch_multitask.py) at 256 px, batch 2, from the port's seed-0
init with the conv kernels scaled (`weights.scale_conv_kernels`), carried
to mmnc_tpu by its importer; mmnc_tpu's EB table in the port's coder (the
two may differ by one count, tests/test_torch_entropy.py). Torch on 2
threads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.models.streaming import stream_roundtrip as j_stream_roundtrip
from mmnc_tpu.train import make_eval_step as j_make_eval_step
from mmnc_tpu.utils.torch_import import import_reference_state_dict

from mmnc_tpu_torch import build_model, graphs
from mmnc_tpu_torch.entropy.tables import CdfTable
from mmnc_tpu_torch.models.streaming import stream_roundtrip
from mmnc_tpu_torch.train import make_eval_step
from mmnc_tpu_torch.weights import scale_conv_kernels

CONFIGS = {"mono": (1, ("mono",)),
           "shared": (4, ("rgb", "depth_euclidean", "semantic"))}
LATENT, CONV, BATCH = 8, 4, 2


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(name, seed=0):
    number, tasks = CONFIGS[name]
    model = scale_conv_kernels(build_model(
        number, tasks, latent_channels=LATENT, conv_channels=CONV,
        lmbda=1e-2, device="cpu", seed=seed))
    model.update_bottleneck_values()
    return model


def _pair(name):
    """(the port codec, mmnc_tpu's codec, its variables and tables on the
    port's weights, a numpy batch); the port codes with JAX's EB table."""
    number, tasks = CONFIGS[name]
    port = _port(name)
    jmodel = j_build_model(number, tasks, latent_channels=LATENT,
                           conv_channels=CONV, lmbda=1e-2)
    variables = {"params": import_reference_state_dict(port.state_dict(),
                                                       jmodel)}
    j_tables = jmodel.update_bottleneck_values(variables)
    port.tables.eb = CdfTable(cdfs=j_tables.eb.cdfs,
                              cdf_lengths=j_tables.eb.cdf_lengths,
                              offsets=j_tables.eb.offsets)
    return port, jmodel, variables, j_tables, port.example_batch(BATCH,
                                                                 seed=1)


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, pairs):
    if request.param not in pairs:
        pairs[request.param] = _pair(request.param)
    return pairs[request.param]


@pytest.fixture(scope="module")
def mono(pairs):
    if "mono" not in pairs:
        pairs["mono"] = _pair("mono")
    return pairs["mono"]


@pytest.fixture(scope="module")
def shared(pairs):
    if "shared" not in pairs:
        pairs["shared"] = _pair("shared")
    return pairs["shared"]


def _inputs(port, batch):
    """The programs' inputs: the batch, the symbols and latents of its
    eager compress, y's coding shape and the last task's index."""
    with graphs.disabled():
        y_sym, z_sym, _ = port._compress_device(batch)
    y_hat = y_sym.float()
    z_hat = z_sym.float() + port._medians().detach().view(1, 1, 1, -1)
    return {"batch": batch, "y_sym": y_sym, "z_sym": z_sym.numpy(),
            "y_hat": y_hat, "z_hat": z_hat, "y_shape": tuple(y_sym.shape[1:3]),
            "y_sym16": y_sym.to(torch.int16), "task": port.n_tasks - 1}


def _jb(batch):
    return {t: jnp.asarray(x) for t, x in batch.items()}


# name: (the port's call, mmnc_tpu's call, its integer outputs compared
# exactly even where they are float32: rounded latents)
PROGRAMS = {
    "_eval_forward": (
        lambda m, a: m._eval_forward(a["batch"]),
        lambda j, v, a: j._eval_forward(v, _jb(a["batch"])), False),
    "encode_eval": (
        lambda m, a: m.encode_eval(a["batch"]),
        lambda j, v, a: j.encode_eval(v, _jb(a["batch"])), True),
    "decode_from_latents": (
        lambda m, a: m.decode_from_latents(a["y_hat"], a["z_hat"]),
        lambda j, v, a: j.decode_from_latents(
            v, a["y_hat"].numpy(), a["z_hat"].numpy()), False),
    "_compress_device": (
        lambda m, a: m._compress_device(a["batch"]),
        lambda j, v, a: j._compress_device(v, _jb(a["batch"])), True),
    "_compress_device_lean": (
        lambda m, a: m._compress_device_lean(a["batch"]),
        lambda j, v, a: j._compress_device_lean(v, _jb(a["batch"])), True),
    "_compress_device_fused": (
        lambda m, a: m._compress_device_fused(a["batch"]),
        lambda j, v, a: j._compress_device_fused(v, _jb(a["batch"])), True),
    "_decompress_indexes_u8": (
        lambda m, a: m._decompress_indexes_u8(a["z_sym"], a["y_shape"]),
        lambda j, v, a: j._decompress_indexes_u8(v, a["z_sym"],
                                                 a["y_shape"]), True),
    "_decompress_indexes": (
        lambda m, a: m._decompress_indexes(a["z_sym"], a["y_shape"]),
        lambda j, v, a: j._decompress_indexes(v, a["z_sym"], a["y_shape"]),
        True),
    "_synthesize_from_symbols": (
        lambda m, a: m._synthesize_from_symbols(a["y_sym16"]),
        lambda j, v, a: j._synthesize_from_symbols(
            v, a["y_sym16"].numpy()), False),
    "_decompress_synthesize": (
        lambda m, a: m._decompress_synthesize(a["y_hat"]),
        lambda j, v, a: j._decompress_synthesize(v, a["y_hat"].numpy()),
        False),
    "_synthesize_task": (
        lambda m, a: m._synthesize_task(a["y_hat"], a["task"]),
        lambda j, v, a: j._synthesize_task(v, a["y_hat"].numpy(), a["task"]),
        False),
}


def _leaves(tree):
    """The arrays of an output tree, dicts in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _derived_caches(model):
    return {name: m.__dict__.get("_derived_cache") for name, m in
            model.named_modules() if m.__dict__.get("_derived_cache")}


def _assert_bitwise(got, want, what):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), what
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), what


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_capture_body_equals_eager_and_mmnc_tpus_program(pair, program,
                                                         monkeypatch):
    port, jmodel, variables, _, batch = pair
    call, j_call, exact = PROGRAMS[program]
    inputs = _inputs(port, batch)
    call(port, inputs)  # the eager program, its derived tensors cached
    cached = _derived_caches(port)
    assert cached
    want = call(port, inputs)
    for module in port.modules():
        module.__dict__.pop("_derived_cache", None)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "capturing", lambda device: True)
        got = call(port, inputs)
    assert _derived_caches(port) == {}  # nothing cached while capturing
    _assert_bitwise(got, want, program)

    j_got = _leaves(j_call(jmodel, variables, inputs))
    got = _leaves(got)
    assert len(got) == len(j_got)
    for g, j in zip(got, j_got):
        g, j = _as_numpy(g), np.asarray(j)
        assert g.shape == j.shape, program
        if exact or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, j, err_msg=program)
        else:
            np.testing.assert_allclose(g, j, rtol=1e-3, atol=1e-4,
                                       err_msg=program)


def test_eval_step_capture_body_equals_eager_and_mmnc_tpus(pair,
                                                           monkeypatch):
    port, jmodel, variables, _, batch = pair
    step = make_eval_step(port)
    want = step(batch)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "capturing", lambda device: True)
        got = step(batch)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    j_logs = j_make_eval_step(jmodel)(variables["params"], _jb(batch))
    assert set(got) == set(j_logs)
    for k, v in j_logs.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-4,
                                   err_msg=k)


@pytest.fixture
def fake_card(monkeypatch):
    """The graph path on the CPU: `_on_card` says yes; the warm-up runs the
    body; a capture records it (its outputs are computed once from the
    zeroed static inputs, as placeholders); a replay runs it again in
    capturing mode and writes the static outputs, which `_Graph.replay`
    then clones. Each appends its name to the returned list."""
    events = []
    replaying = [False]

    def in_capture(fn):
        replaying[0] = True
        try:
            return fn()
        finally:
            replaying[0] = False

    class FakeGraph:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            events.append("replay")
            fresh = in_capture(self.fn)
            for static, x in zip(_leaves(self.outputs), _leaves(fresh)):
                static.copy_(x)

        def pool(self):
            return "pool"

    def warm_up(body, *args, stream):
        events.append("warm-up")
        return body(*args)

    def capture(fn, stream, pool=None):
        events.append("capture")
        graph = FakeGraph(fn)
        graph.outputs = in_capture(fn)
        return graph, graph.outputs

    monkeypatch.setattr(graphs, "_on_card", lambda model: True)
    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "capturing", lambda device: replaying[0])
    return events


def _eager(fn):
    with graphs.disabled():
        return fn()


def test_warm_up_capture_replay_and_reuse(fake_card):
    port = _port("mono")
    batches = [port.example_batch(BATCH, seed=s) for s in (1, 2, 3, 1)]
    outs = [port._compress_device(b) for b in batches]
    assert fake_card == ["warm-up", "capture", "replay", "replay", "replay"]
    stats = graphs.stats(port, "_compress_device")
    assert (stats["eager"], stats["captures"], stats["replays"]) == (1, 1, 3)
    assert len(stats["capture_s"]) == 1
    for batch, out in zip(batches, outs):
        _assert_bitwise(out, _eager(lambda: port._compress_device(batch)),
                        "compress")


def test_a_new_signature_warms_up_anew(fake_card):
    port = _port("shared")
    batch = port.example_batch(BATCH, seed=1)
    inputs = _inputs(port, batch)
    z, y_shape = inputs["z_sym"], inputs["y_shape"]

    def twice(fn):
        del fake_card[:]
        fn()
        fn()
        return list(fake_card)

    warm = ["warm-up", "capture", "replay"]
    assert twice(lambda: port._compress_device(batch)) == warm
    one = {t: x[:1] for t, x in batch.items()}
    assert twice(lambda: port._compress_device(one)) == warm  # batch size
    wide = {t: x.astype(np.float64) for t, x in batch.items()}
    assert twice(lambda: port._compress_device(wide)) == warm  # type
    assert twice(lambda: port._decompress_indexes_u8(z, y_shape)) == warm
    assert twice(lambda: port._decompress_indexes_u8(z, (2, 2))) == warm
    y_hat = inputs["y_hat"]
    for task in range(port.n_tasks):  # task_index
        assert twice(lambda: port._synthesize_task(y_hat, task)) == warm
    for flag in ("deterministic", "benchmark"):
        before = getattr(torch.backends.cudnn, flag)
        setattr(torch.backends.cudnn, flag, not before)
        try:
            assert twice(lambda: port._compress_device(batch)) == warm
        finally:
            setattr(torch.backends.cudnn, flag, before)
    del fake_card[:]
    port._compress_device(batch)  # the first signature, still kept
    assert fake_card == ["replay"]
    _assert_bitwise(port._compress_device(wide),
                    _eager(lambda: port._compress_device(wide)), "float64")


def test_in_place_updates_keep_the_graph_and_replay_the_new_parameters(
        fake_card):
    """An optimizer-style update in place and a load_state_dict of other
    weights keep each parameter's storage: the next calls replay, and
    equal the eager programs on the new parameters (whose `_derived`
    caches see the new versions)."""
    port = _port("mono")
    batch = port.example_batch(BATCH, seed=1)
    y_hat = _inputs(port, batch)["y_hat"]
    step = make_eval_step(port)
    for _ in range(2):  # warm-up and capture
        port._decompress_synthesize(y_hat)
        step(batch)
    initial = _eager(lambda: port._decompress_synthesize(y_hat))
    other = _port("mono", seed=1).state_dict()
    for update in ("in place", "load_state_dict"):
        with torch.no_grad():
            if update == "in place":
                for p in port.parameters():
                    p.mul_(1.01)
            else:
                port.load_state_dict(other)
        del fake_card[:]
        got = port._decompress_synthesize(y_hat), step(batch)
        assert fake_card == ["replay", "replay"], update
        want = _eager(lambda: (port._decompress_synthesize(y_hat),
                               step(batch)))
        _assert_bitwise(got, want, update)
        assert not torch.equal(got[0]["mono"], initial["mono"]), update


def test_the_bound_drops_the_least_recently_used(fake_card, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    port = _port("mono")
    batch = port.example_batch(3, seed=1)
    sizes = {n: {t: x[:n] for t, x in batch.items()} for n in (1, 2, 3)}
    for n in (1, 1, 2, 1, 3):  # 2 is then the least recently used
        port._compress_device(sizes[n])
    assert fake_card == ["warm-up", "capture", "replay", "warm-up", "replay",
                         "warm-up"]
    del fake_card[:]
    port._compress_device(sizes[1])
    port._compress_device(sizes[2])
    assert fake_card == ["replay", "warm-up"]


def test_outputs_of_two_calls_never_alias(fake_card):
    port = _port("mono")
    a, b = (port.example_batch(BATCH, seed=s) for s in (1, 2))
    for _ in range(2):
        port._eval_forward(a)
    first = port._eval_forward(a)
    kept = [x.clone() for x in _leaves(first)]
    second = port._eval_forward(b)
    assert fake_card[-2:] == ["replay", "replay"]
    ptrs = {x.data_ptr() for x in _leaves(first)}
    assert not ptrs & {x.data_ptr() for x in _leaves(second)}
    for x, k in zip(_leaves(first), kept):
        assert torch.equal(x, k)
    _assert_bitwise(second, _eager(lambda: port._eval_forward(b)), "second")


def test_disabled_runs_eagerly(fake_card):
    port = _port("mono")
    batch = port.example_batch(BATCH, seed=1)
    with graphs.disabled():
        for _ in range(3):
            port._compress_device_fused(batch)
    assert fake_card == []
    assert graphs.stats(port, "_compress_device_fused")["eager"] == 3
    port._compress_device_fused(batch)
    assert fake_card == ["warm-up"]


def test_a_failed_capture_raises(fake_card, monkeypatch):
    def refuse(fn, stream, pool=None):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "capture", refuse)
    port = _port("mono")
    batch = port.example_batch(BATCH, seed=1)
    port._compress_device(batch)  # the warm-up
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture refused"):
            port._compress_device(batch)
    assert graphs.stats(port, "_compress_device")["replays"] == 0


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_stream_through_graphs_equals_compress_and_mmnc_tpus_stream(
        pair, fake_card, impl):
    port, jmodel, variables, j_tables, _ = pair
    batches = [port.example_batch(BATCH, seed=s) for s in (1, 2, 3)]
    got = list(stream_roundtrip(port, batches, impl=impl))
    programs = (("_compress_device_fused", "_synthesize_from_symbols")
                if impl == "v2" else
                ("_compress_device_lean", "_decompress_indexes_u8",
                 "_synthesize_from_symbols"))
    for name in programs:
        stats = graphs.stats(port, name)
        assert stats["captures"] >= 1 and stats["replays"] >= 1, name
    want = list(j_stream_roundtrip(jmodel, variables, j_tables,
                                   [_jb(b) for b in batches], impl=impl))
    for batch, (x_hats, n_bytes), (j_hats, j_bytes) in zip(batches, got,
                                                           want):
        assert n_bytes == j_bytes == port.compress(batch)[1]
        for t in port.tasks:
            np.testing.assert_allclose(x_hats[t].numpy(),
                                       np.asarray(j_hats[t]), rtol=1e-3,
                                       atol=1e-4, err_msg=t)


def test_eval_step_through_graphs_equals_mmnc_tpus(shared, fake_card):
    port, jmodel, variables, _, batch = shared
    step = make_eval_step(port)
    j_logs = j_make_eval_step(jmodel)(variables["params"], _jb(batch))
    want = _eager(lambda: step(batch))
    for _ in range(3):
        logs = step(batch)
        for k, v in j_logs.items():
            assert torch.equal(logs[k], want[k]), k
            np.testing.assert_allclose(logs[k].item(), float(v), rtol=1e-4,
                                       err_msg=k)
    assert fake_card == ["warm-up", "capture", "replay", "replay"]
    assert step.stats["replays"] == 2
