"""The train call and the eval step under a mesh as CUDA graphs
(`train/step.py`), checked on the CPU.

On a card under an NCCL mesh (`Mesh.captures`) a rank's K-step call and
its eval step are CUDA graphs with the all-reduces captured inside them;
under a gloo mesh both stay eager. The CPU has neither NCCL nor graphs,
so a fake card stands in: the mesh says NCCL but its group is gloo, the
warm-up runs the body, a capture records it and a replay runs it again
(its collectives then run as the graph's would, once a replay on every
rank), and each counts itself. Against that:

* (a) under a one-rank "NCCL" mesh in this process, three K = 2 calls
  warm up, capture and replay (warm-up, capture, replay, replay), the
  state's signature holds the mesh (its size and a rank's rows), and the
  parameters equal six eager `make_train_step` steps bitwise; a failed
  capture raises, and nothing carries on eagerly;
* the lower-bound gate of a GDN parameter applies to the gradient summed
  over the ranks, as to the global batch's, not to each rank's share
  (`ops/bound.py:gates_after_reduce`): shares that disagree in sign;
* (b) a gloo mesh stays eager: its eval step counts eager calls only
  (tests/test_torch_graph_step.py holds its train call);
* (c) two spawned CPU ranks, each with the fake card and an "NCCL" mesh:
  their three K = 2 calls equal mmnc_tpu's `make_multi_train_step` on
  the global batch, on the same weights and injected noise, at
  tests/test_torch_graph_step.py's tolerances (loss rtol 1e-5, the
  gradient norm rtol 1e-4, parameters rtol 1e-4 / atol 1e-6); the ranks'
  parameters are bitwise equal;
* (d) the mesh eval step is a program of its own (`eval_program`), keyed
  apart from the unmeshed one on the same model; through the fake graphs
  its logs equal mmnc_tpu's eval step on the global batch (rtol 1e-3 /
  atol 1e-4, tests/test_torch_parallel.py's two-rank bound) and the
  single-process eval step's (rtol 1e-5).

The mono codec (m=8, c=4 at 256 px, global batch 4: 2 rows a rank) from
the port's seed-0 init with the conv kernels scaled
(`weights.scale_conv_kernels`), carried to mmnc_tpu by its importer;
torch on 2 threads. This module imports JAX only inside its JAX fixture,
so the spawned ranks start fast.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmnc_tpu_torch import build_model, graphs
from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                 prerender)
from mmnc_tpu_torch.ops.bound import gates_after_reduce, lower_bound
from mmnc_tpu_torch.parallel import Mesh, launch, make_mesh, shard_batch
from mmnc_tpu_torch.train import (create_train_state, make_eval_step,
                                  make_multi_train_step, make_train_step)
from mmnc_tpu_torch.train import step as step_module
from mmnc_tpu_torch.train.step import eval_program, graph_signature, step_seed
from mmnc_tpu_torch.weights import scale_conv_kernels

LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS, K, SEED, CLIP = (1e-2, 1e-3, 1e-3, 10,
                                                      2, 9, 0.5)
GLOBAL_BATCH, CALLS = 4, 3
TIMEOUT = 300  # seconds a launch of these tests may take


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(state_dict=None):
    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, learning_rate_main=LR_MAIN,
                        learning_rate_aux=LR_AUX, device="cpu")
    if state_dict is None:
        return scale_conv_kernels(model)
    model.load_state_dict(state_dict)
    return model


def _micro():
    """K micro-batches of the global batch (numpy)."""
    data = prerender(SyntheticMultiTaskDataset(["mono"],
                                               size=GLOBAL_BATCH * K, seed=0))
    return list(BatchLoader(data, GLOBAL_BATCH, shuffle=False).epoch(0))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _fake_card(mp, events):
    """The graph paths on the CPU (train calls and device programs): the
    card says yes; a warm-up runs the body; a train graph's capture
    records it and each replay runs it; a program's capture runs its body
    once for the static outputs and each replay runs it again into them,
    in capturing mode. Each appends its name to `events`."""
    replaying = [False]

    def in_capture(fn):
        replaying[0] = True
        try:
            return fn()
        finally:
            replaying[0] = False

    def warm_up(body, *args, stream):
        events.append("warm-up")
        return body(*args)

    class TrainGraph:
        def __init__(self, body, state, batches, noises, stream):
            events.append("capture")
            self.body, self.state, self.capture_s = body, state, 0.0

        def replay(self, params, batches, noises, lrs):
            events.append("replay")
            return self.body(self.state, batches, noises, lrs)

    class ProgramGraph:
        def __init__(self, fn):
            self.fn = fn
            self.outputs = in_capture(fn)

        def replay(self):
            events.append("replay")
            fresh = in_capture(self.fn)
            for static, x in zip(_leaves(self.outputs), _leaves(fresh)):
                static.copy_(x)

        def pool(self):
            return "pool"

    def capture(fn, stream, pool=None):
        events.append("capture")
        graph = ProgramGraph(fn)
        return graph, graph.outputs

    mp.setattr(step_module, "_on_card", lambda model: True)
    mp.setattr(step_module, "_capture_stream", lambda device: None)
    mp.setattr(step_module, "_warm_up", warm_up)
    mp.setattr(step_module, "_TrainGraph", TrainGraph)
    mp.setattr(graphs, "_on_card", lambda model: True)
    mp.setattr(graphs, "capture_stream", lambda device: None)
    mp.setattr(graphs, "warm_up", warm_up)
    mp.setattr(graphs, "capture", capture)
    mp.setattr(graphs, "capturing", lambda device: replaying[0])


@pytest.fixture
def fake_card(monkeypatch):
    events = []
    _fake_card(monkeypatch, events)
    return events


@pytest.fixture
def one_rank():
    """A one-rank gloo process group in this process, and its mesh as
    make_mesh gives it (backend "gloo")."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def _nccl(mesh):
    """The mesh as an NCCL one reports itself; its group stays gloo."""
    return dataclasses.replace(mesh, backend="nccl")


# --- the mesh and the signature ----------------------------------------------

def test_a_mesh_reports_whether_its_collectives_capture(one_rank):
    assert one_rank.backend == "gloo" and not one_rank.captures
    assert _nccl(one_rank).captures
    assert Mesh(0, 2, torch.device("cpu"), None, None).backend == "gloo"


def test_the_signature_holds_the_mesh_every_rank_shares():
    def batches(rows):
        return [{"mono": torch.zeros(rows, 256, 256, 1)}] * K

    ranks = [Mesh(r, 2, torch.device("cpu"), None, None, "nccl")
             for r in range(2)]
    plain = graph_signature(batches(2), False, CLIP, False)
    keys = [graph_signature(batches(2), False, CLIP, False, m) for m in ranks]
    assert keys[0] == keys[1] == plain + (("mesh", 2, 2),)
    wider = Mesh(0, 4, torch.device("cpu"), None, None, "nccl")
    for other in (graph_signature(batches(2), False, CLIP, False, wider),
                  graph_signature(batches(1), False, CLIP, False, ranks[0])):
        assert other != keys[0]


def test_bound_gates_apply_to_the_reduced_gradient():
    """A parameter below its lower bound, whose two ranks' gradients
    disagree in sign and sum to one that pushes it further down: the
    global batch's step holds it (gradient 0); gated a rank at a time and
    then averaged, it would move."""
    bound = 1.0
    shares = (-1.0, 3.0)

    def grad(g, defer):
        p = torch.nn.Parameter(torch.tensor([0.5]))
        with (gates_after_reduce([p]) if defer
              else contextlib.nullcontext()) as gate:
            (lower_bound(p, bound) * g).sum().backward()
        return p, gate

    gated = [grad(g, False)[0].grad for g in shares]
    assert torch.equal(sum(gated) / 2, torch.tensor([-0.5]))
    ranks = [grad(g, True) for g in shares]
    mean = sum(p.grad for p, _ in ranks) / 2
    p, gate = ranks[0]
    p.grad.copy_(mean)
    gate()
    assert torch.equal(p.grad, torch.tensor([0.0]))
    assert torch.equal(grad(sum(shares) / 2, False)[0].grad, p.grad)


def test_chip_smoke_finds_the_reduction_among_a_replays_records():
    """chip_smoke reads the in-graph reduction's device ms from a replay's
    records by the kinds of the records an eager step launched in its
    `train.all_reduce` span; a device-to-device copy is a copy record
    eagerly and a "memcpy32_post" kernel in a graph."""
    import chip_smoke

    def record(name, ts, dur, cat="kernel"):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": 7}}

    span = [record("cat", 0, 1.0), record("ncclKernel_AllReduce", 1, 2.0),
            record("div", 2, 1.0),
            record("Memcpy DtoD (Device -> Device)", 3, 1.0, "gpu_memcpy")]
    replay = [{"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0,
               "dur": 1, "args": {"correlation": 7}},
              record("conv", 1, 50.0), record("cat", 2, 3.0),
              record("ncclKernel_AllReduce", 3, 4000.0),
              record("div", 4, 1000.0), record("memcpy32_post", 5, 2000.0),
              record("adam", 6, 9.0)]
    got = chip_smoke.in_graph_reduction(replay, span)
    assert got == {"nodes": 4, "nccl_ms": 4.0, "copy_ms": 3.003}
    assert chip_smoke.in_graph_reduction(replay[:4], span) is None


# --- (a) one rank in this process --------------------------------------------

def _eager_steps(state_dict, micro, calls):
    model = _port(state_dict)
    state = create_train_state(model, TOTAL_STEPS)
    step = make_train_step(model, clip_norm=CLIP)
    gen = torch.Generator()
    for _ in range(calls):
        for batch in micro:
            gen.manual_seed(step_seed(SEED, state.step))
            state, logs = step(state, batch, gen)
    return model, logs


def test_nccl_mesh_call_warms_up_captures_and_replays(fake_card, one_rank):
    micro = _micro()
    state_dict = _port().state_dict()
    want_model, want_logs = _eager_steps(state_dict, micro, CALLS)
    mesh = _nccl(one_rank)
    model = _port(state_dict)
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K, clip_norm=CLIP, mesh=mesh)
    gen = torch.Generator()
    for _ in range(CALLS):
        state, logs = multi(state, micro, gen, SEED)
    assert fake_card == ["warm-up", "capture", "replay", "replay"]
    assert (multi.stats["eager"], multi.stats["captures"],
            multi.stats["replays"]) == (1, 1, 2)
    assert state.step == CALLS * K
    assert state.graph[0] == graph_signature(
        [model.to_device(m) for m in micro], False, CLIP, False, mesh)
    assert state.graph[0][-1] == ("mesh", 1, GLOBAL_BATCH)
    for k in ("train/loss", "train/grad_norm"):
        assert torch.equal(logs[k].float(), want_logs[k].float()), k
    for name, p in want_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name


def test_a_failed_capture_under_an_nccl_mesh_raises(fake_card, one_rank,
                                                    monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(step_module, "_TrainGraph", refuse)
    model = _port()
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K, clip_norm=CLIP,
                                  mesh=_nccl(one_rank))
    micro = _micro()
    state, _ = multi(state, micro, torch.Generator(), SEED)
    with pytest.raises(RuntimeError, match="capture refused"):
        multi(state, micro, torch.Generator(), SEED)
    assert state.step == K and fake_card == ["warm-up"]
    assert (multi.stats["eager"], multi.stats["replays"]) == (1, 0)


def test_fit_in_a_one_rank_group_replays_its_mesh_graphs(fake_card, one_rank,
                                                        monkeypatch,
                                                        tmp_path):
    """`fit(n_devices=1)` in a process group of one trains on its mesh:
    under an "NCCL" one its train calls and eval steps warm up, capture
    and replay, and it ends where `fit` without a mesh ends, bitwise."""
    from mmnc_tpu_torch.train import fit
    from mmnc_tpu_torch.train import loop

    data = prerender(SyntheticMultiTaskDataset(["mono"], size=8, seed=0))
    meshes = []

    def nccl_mesh(n, device=None):
        meshes.append(_nccl(make_mesh(n, device)))
        return meshes[-1]

    monkeypatch.setattr(loop, "make_mesh", nccl_mesh)
    models = []
    for n_devices in (1, None):
        models.append(_port(_port().state_dict()))
        fit(models[-1], BatchLoader(data, 2),
            BatchLoader(data, 2, shuffle=False), epochs=1,
            run_name=f"n{n_devices}", out_dir=str(tmp_path),
            log_images=False, n_devices=n_devices)
    assert len(meshes) == 1 and meshes[0].world_size == 1
    # each run: 4 train calls, then 4 eval steps (a capture replays too)
    one = ["warm-up", "capture", "replay", "replay", "replay"]
    assert fake_card == one * 4
    for model, name in zip(models, (eval_program(meshes[0]), "eval_step")):
        stats = graphs.all_stats(model)
        assert set(stats) == {name}
        assert (stats[name]["eager"], stats[name]["captures"],
                stats[name]["replays"]) == (1, 1, 3)
    for name, p in models[1].state_dict().items():
        assert torch.equal(models[0].state_dict()[name], p), name


# --- (b) a gloo mesh stays eager ---------------------------------------------

def test_gloo_mesh_eval_step_counts_eager_calls_only(fake_card, one_rank):
    """The step runs eagerly; the eval forward it calls, which holds no
    collective, is the model's own program and replays as without a
    mesh."""
    model = _port()
    step = make_eval_step(model, mesh=one_rank)
    batch = _micro()[0]
    want = make_eval_step(model)(batch)  # the unmeshed program's warm-up
    del fake_card[:]
    for _ in range(3):
        logs = step(batch)
    assert (step.stats["eager"], step.stats["captures"],
            step.stats["replays"]) == (3, 0, 0)
    forward = graphs.stats(model, "_eval_forward")
    assert (forward["captures"], forward["replays"]) == (1, 2)
    assert fake_card == ["warm-up", "capture", "replay", "replay"]
    for k, v in want.items():
        np.testing.assert_allclose(logs[k].item(), v.item(), rtol=1e-6,
                                   err_msg=k)


# --- (d) the mesh eval step's program ----------------------------------------

def test_the_mesh_eval_program_is_keyed_apart(fake_card, one_rank):
    """At world size 1 the rank's rows are the whole batch, the same
    shapes as the unmeshed step's: its program still warms up on its
    own, and neither replays the other's graph."""
    mesh = _nccl(one_rank)
    model = _port()
    batch = _micro()[0]
    plain, meshed = make_eval_step(model), make_eval_step(model, mesh=mesh)
    assert eval_program(mesh) == "eval_step[mesh 1, rank 0]"
    assert eval_program(None) == "eval_step"
    for _ in range(2):
        want = plain(batch)
    assert fake_card == ["warm-up", "capture", "replay"]
    for _ in range(3):
        got = meshed(batch)
    assert fake_card[3:] == ["warm-up", "capture", "replay", "replay"]
    assert set(graphs.all_stats(model)) >= {"eval_step", eval_program(mesh)}
    assert (plain.stats["captures"], plain.stats["replays"]) == (1, 1)
    assert (meshed.stats["captures"], meshed.stats["replays"]) == (1, 2)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), v.item(), rtol=1e-6,
                                   err_msg=k)


# --- (c), (d) two spawned ranks ----------------------------------------------

def _rank(mesh, state_dict, micro, noise):
    """A rank of (c) and (d) with the fake card and an "NCCL" mesh: the
    mesh eval step three times on the rank's rows of the first global
    batch and the unmeshed one once on all of it, then CALLS K = 2 calls
    on the rank's rows with `noise` (the global batch's) at every
    micro-step -> numpy and floats."""
    events = []
    mp = pytest.MonkeyPatch()
    _fake_card(mp, events)
    try:
        mesh = _nccl(mesh)
        model = _port(state_dict)
        rows = [shard_batch(b, mesh) for b in micro]
        meshed = make_eval_step(model, compute_metrics=True, mesh=mesh)
        val = [meshed(rows[0]) for _ in range(3)]
        single_val = make_eval_step(model, compute_metrics=True)(micro[0])
        state = create_train_state(model, TOTAL_STEPS)
        multi = make_multi_train_step(model, K, clip_norm=CLIP, mesh=mesh)
        noise = {k: torch.from_numpy(v) for k, v in noise.items()}
        losses, logs = [], None
        for _ in range(CALLS):
            state, logs = multi(state, rows, noise=noise)
            losses.append(logs["train/loss"].item())
        return {"events": events, "losses": losses,
                "grad_norm": logs["train/grad_norm"].item(),
                "signature": state.graph[0][-1],
                "stats": {k: v for k, v in multi.stats.items()
                          if k != "capture_s"},
                "val": [{k: v.item() for k, v in logs.items()}
                        for logs in val],
                "single_val": {k: v.item() for k, v in single_val.items()},
                "params": {k: v.numpy().copy()
                           for k, v in model.state_dict().items()}}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def two_ranks():
    """mmnc_tpu's multi-step (CALLS calls of K = 2, one numpy noise at
    every micro-step, JAX's quantize_noise patched) and eval step on the
    global batch, and the two ranks' run of `_rank`."""
    import jax
    import jax.numpy as jnp

    from mmnc_tpu.entropy import entropy_bottleneck as j_eb
    from mmnc_tpu.entropy import gaussian_conditional as j_gc
    from mmnc_tpu.models import build_model as j_build_model
    from mmnc_tpu.train import create_train_state as j_create_train_state
    from mmnc_tpu.train import make_eval_step as j_make_eval_step
    from mmnc_tpu.train import make_multi_train_step as j_multi
    from mmnc_tpu.utils.torch_import import import_reference_state_dict
    from mmnc_tpu_torch.weights import state_dict_from_jax

    micro = _micro()
    state_dict = _port().state_dict()
    shapes = _port(state_dict).latent_shapes(micro[0])
    rng = np.random.default_rng(5)
    noise = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
             for k, s in shapes.items()}
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}
    assert len(by_shape) == 2

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    jmodel = j_build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA, learning_rate_main=LR_MAIN)
    params = import_reference_state_dict(state_dict, jmodel)
    j_val = j_make_eval_step(jmodel)(params, {
        t: jnp.asarray(x) for t, x in micro[0].items()})
    j_losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        j_state = j_create_train_state(params, TOTAL_STEPS,
                                       learning_rate_main=LR_MAIN,
                                       learning_rate_aux=LR_AUX)
        multi = j_multi(jmodel, K, donate=False, clip_norm=CLIP)
        super_batch = {t: np.stack([m[t] for m in micro]) for t in micro[0]}
        for _ in range(CALLS):
            j_state, j_logs = multi(j_state, super_batch,
                                    jax.random.PRNGKey(0))
            j_losses.append(float(j_logs["train/loss"]))
    ranks = launch(_rank, 2, "cpu", state_dict, micro, noise,
                   timeout=TIMEOUT)
    return {"ranks": ranks, "losses": j_losses,
            "grad_norm": float(j_logs["train/grad_norm"]),
            "val": {k: float(v) for k, v in jax.device_get(j_val).items()},
            "params": {k: v.numpy() for k, v in state_dict_from_jax(
                jax.device_get(j_state.params)).items()}}


def test_two_ranks_graphed_calls_equal_mmnc_tpus_multi_step(two_ranks):
    ranks, want = two_ranks["ranks"], two_ranks
    for rank in ranks:
        # the eval program's warm-up, capture, replay, replay, then the
        # unmeshed eval program's warm-up, then the train call's
        assert rank["events"] == ["warm-up", "capture", "replay", "replay",
                                  "warm-up", "warm-up", "capture", "replay",
                                  "replay"]
        assert rank["stats"] == {"eager": 1, "captures": 1, "replays": 2}
        assert rank["signature"] == ("mesh", 2, GLOBAL_BATCH // 2)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    got, other = ranks[0]["params"], ranks[1]["params"]
    assert set(got) == set(want["params"])
    for name, w in want["params"].items():
        np.testing.assert_array_equal(other[name], got[name], err_msg=name)
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_two_ranks_graphed_eval_step_equals_mmnc_tpus(two_ranks):
    ranks, want = two_ranks["ranks"], two_ranks["val"]
    for rank in ranks:
        assert set(rank["single_val"]) == set(want)
        for logs in rank["val"]:
            assert logs == ranks[0]["val"][0]
    got = ranks[0]["val"][0]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(got[name], ranks[0]["single_val"][name],
                                   rtol=1e-5, err_msg=name)
