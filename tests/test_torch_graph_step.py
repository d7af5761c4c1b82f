"""The K-step train call of the port (`train/step.py:make_multi_train_step`)
as the CUDA graph runs it, checked on the CPU.

On a card the call is one captured graph of K whole steps; on the CPU the
same body runs eagerly, so these tests hold that body, and the host side
of the graph path, to their references:

* the body equals K `make_train_step` calls bitwise (a stacked
  super-batch and a list; plain and remat), and mmnc_tpu's
  `make_multi_train_step` on the same params and injected noise at
  tests/test_torch_multistep.py's tolerances (loss rtol 1e-5, parameters
  rtol 1e-4 / atol 1e-6; the gradient norm at test_torch_train.py's
  rtol 1e-4 for logs);
* the noise drawn ahead (`step_noises`) equals per-step draws bitwise,
  and the K main-group rates equal `cosine_lr` at step + i and optax's
  `cosine_decay_schedule` (rtol 1e-6, optax's float32);
* `TrainState.state_dict` keeps its form when the rate is a device-style
  tensor (a float, capturable off), a checkpoint of a capturable state
  resumes on the CPU, and `load_state_dict` drops the graph;
* the state's one graph, with the warm-up and the capture replaced by
  fakes that run the body eagerly: same shapes reuse it; a new shape, K
  or `compute_metrics` drops it and warms up anew, and so does
  `load_state_dict`; the signature tells a dtype apart; under a mesh
  (one gloo rank in this process) the call stays eager;
* torch refuses `capturable=True` on CPU parameters, which is why the
  CPU's Adam is not capturable.

The mono codec (m=8, c=4 at 256 px, batch 2) from the port's seed-0
init, carried to mmnc_tpu by its importer; torch on 2 threads.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                 prerender)
from mmnc_tpu_torch.parallel import make_mesh
from mmnc_tpu_torch.train import (create_train_state, make_multi_train_step,
                                  make_train_step)
from mmnc_tpu_torch.train import step as step_module
from mmnc_tpu_torch.train.state import cosine_lr
from mmnc_tpu_torch.train.step import graph_signature, step_noises, step_seed

LMBDA, LR_MAIN, LR_AUX, TOTAL_STEPS, K, SEED, CLIP = (1e-2, 1e-3, 1e-3, 10,
                                                      2, 9, 0.5)


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(state_dict=None, dtype=None):
    kwargs = {} if dtype is None else {"dtype": dtype}
    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        lmbda=LMBDA, learning_rate_main=LR_MAIN,
                        learning_rate_aux=LR_AUX, device="cpu", **kwargs)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def setup():
    """The port's seed-0 state_dict and K micro-batches of 2."""
    data = prerender(SyntheticMultiTaskDataset(["mono"], size=2 * K, seed=0))
    micro = list(BatchLoader(data, 2, shuffle=False).epoch(0))
    return {"state_dict": _port().state_dict(), "micro": micro}


def _eager_steps(state_dict, micro, remat=False):
    model = _port(state_dict)
    state = create_train_state(model, TOTAL_STEPS)
    step = make_train_step(model, clip_norm=CLIP, remat=remat)
    gen = torch.Generator()
    for batch in micro:
        gen.manual_seed(step_seed(SEED, state.step))
        state, logs = step(state, batch, gen)
    return model, state, logs


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("form", ["stacked", "list"])
def test_body_equals_k_train_steps_bitwise(setup, form, remat):
    micro = setup["micro"]
    want_model, want_state, want_logs = _eager_steps(setup["state_dict"],
                                                     micro, remat)
    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K, compute_metrics=True,
                                  clip_norm=CLIP, remat=remat)
    super_batch = ({t: np.stack([m[t] for m in micro]) for t in micro[0]}
                   if form == "stacked" else micro)
    state, logs = multi(state, super_batch, torch.Generator(), SEED)
    assert state.step == want_state.step == K
    assert multi.stats["eager"] == 1 and state.graph is None
    assert set(logs) == set(want_logs)
    for k, v in want_logs.items():
        assert torch.equal(logs[k], v), k
    for name, p in want_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name
    for p, q in zip(want_model.parameters(), model.parameters()):
        for key, v in want_state.optimizer.state[p].items():
            assert torch.equal(state.optimizer.state[q][key], v), key


def test_body_equals_mmnc_tpus_multi_step(setup):
    """K = 2 with an engaging clip, one numpy noise at every micro-step
    (JAX's quantize_noise patched; the port's `noise=`)."""
    import jax
    import jax.numpy as jnp

    from mmnc_tpu.entropy import entropy_bottleneck as j_eb
    from mmnc_tpu.entropy import gaussian_conditional as j_gc
    from mmnc_tpu.models import build_model as j_build_model
    from mmnc_tpu.train import create_train_state as j_create_train_state
    from mmnc_tpu.train import make_multi_train_step as j_multi
    from mmnc_tpu.utils.torch_import import import_reference_state_dict
    from mmnc_tpu_torch.weights import state_dict_from_jax

    rng = np.random.default_rng(5)
    noise = {"y": rng.uniform(-0.5, 0.5, (2, 1, 1, 8)).astype(np.float32),
             "z": rng.uniform(-0.5, 0.5, (2, 1, 1, 4)).astype(np.float32)}
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}

    def fixed(x, key):
        del key
        return x + by_shape[tuple(x.shape)]

    micro = setup["micro"]
    jmodel = j_build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                           lmbda=LMBDA, learning_rate_main=LR_MAIN)
    params = import_reference_state_dict(setup["state_dict"], jmodel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_eb, "quantize_noise", fixed)
        mp.setattr(j_gc, "quantize_noise", fixed)
        j_state = j_create_train_state(params, TOTAL_STEPS,
                                       learning_rate_main=LR_MAIN,
                                       learning_rate_aux=LR_AUX)
        j_state, j_logs = j_multi(jmodel, K, donate=False, clip_norm=CLIP)(
            j_state, {t: np.stack([m[t] for m in micro]) for t in micro[0]},
            jax.random.PRNGKey(0))

    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K, clip_norm=CLIP)
    state, logs = multi(state, micro, noise={
        k: torch.from_numpy(v) for k, v in noise.items()})
    assert state.step == int(j_state.step) == K
    np.testing.assert_allclose(logs["train/loss"].item(),
                               float(j_logs["train/loss"]), rtol=1e-5)
    # the other logs at tests/test_torch_train.py's rtol 1e-4
    np.testing.assert_allclose(logs["train/grad_norm"].item(),
                               float(j_logs["train/grad_norm"]), rtol=1e-4)
    got = model.state_dict()
    for name, want in state_dict_from_jax(
            jax.device_get(j_state.params)).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_noise_drawn_ahead_equals_per_step_draws(setup):
    model = _port(setup["state_dict"])
    batches = [model.to_device(b) for b in setup["micro"]]
    ahead = step_noises(model, batches, torch.Generator(), SEED, 5)
    gen = torch.Generator()
    for i, (batch, got) in enumerate(zip(batches, ahead)):
        gen.manual_seed(step_seed(SEED, 5 + i))
        want = model.draw_noise(batch, gen)
        assert got.keys() == want.keys() == {"y", "z"}
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)


def test_learning_rate_slots_follow_the_schedule():
    import optax

    state = create_train_state(_port(), TOTAL_STEPS)
    schedule = optax.cosine_decay_schedule(LR_MAIN, TOTAL_STEPS,
                                           alpha=1e-8 / LR_MAIN)
    for step in (0, 3, TOTAL_STEPS - 2, TOTAL_STEPS + 1):
        state.step = step
        got = state.learning_rates(4)
        assert got == [cosine_lr(step + i, TOTAL_STEPS, LR_MAIN, 1e-8)
                       for i in range(4)]
        np.testing.assert_allclose(got, [float(schedule(step + i))
                                         for i in range(4)], rtol=1e-6)


def test_state_dict_keeps_its_form_and_resumes_across_devices(setup):
    """A state whose main rate is a 0-d tensor (as on the card) saves the
    CPU's form; a capturable state's checkpoint (capturable on, as a
    card writes it without the normalisation) resumes on the CPU, and
    the resumed step equals a step of the state it came from;
    load_state_dict drops the graph."""
    micro = setup["micro"]
    model, state, _ = _eager_steps(setup["state_dict"], micro[:1])
    saved = state.state_dict()
    main, aux = saved["adam"]["param_groups"]
    assert set(saved) == {"step", "total_steps", "learning_rate_main",
                          "eta_min", "adam"}
    assert type(main["lr"]) is float and main["capturable"] is False
    assert main["lr"] == cosine_lr(0, TOTAL_STEPS, LR_MAIN, 1e-8)
    assert (aux["lr"], aux["capturable"]) == (LR_AUX, False)
    state.optimizer.param_groups[0]["lr"] = torch.tensor(
        main["lr"], dtype=torch.float64)
    again = state.state_dict()
    assert again["adam"]["param_groups"] == saved["adam"]["param_groups"]
    assert again["adam"]["state"].keys() == saved["adam"]["state"].keys()

    card_form = dict(saved, adam=dict(saved["adam"], param_groups=[
        dict(g, capturable=True) for g in saved["adam"]["param_groups"]]))
    results = []
    for sd in (saved, card_form):
        resumed = _port(model.state_dict())
        r_state = create_train_state(resumed, TOTAL_STEPS)
        r_state.graph = ("x", step_module.WARMED)
        r_state.load_state_dict(copy.deepcopy(sd))  # as from a file
        assert r_state.graph is None and r_state.step == 1
        assert all(not g["capturable"]
                   for g in r_state.optimizer.param_groups)
        step = make_train_step(resumed, clip_norm=CLIP)
        gen = torch.Generator().manual_seed(step_seed(SEED, 1))
        step(r_state, micro[1], gen)
        results.append(resumed.state_dict())
    for name, p in results[0].items():
        assert torch.equal(results[1][name], p), name


def test_capturable_adam_refuses_cpu_parameters():
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], capturable=True)
    p.grad = torch.ones(3)
    with pytest.raises(AssertionError, match="capturable=True"):
        opt.step()
    state = create_train_state(_port(), 4)
    assert state.device_lr is None
    assert not any(g["capturable"] for g in state.optimizer.param_groups)


def test_graph_signature_tells_calls_apart():
    def batches(k, shape=(2, 256, 256, 1), dtype=torch.float32):
        return [{"mono": torch.zeros(shape, dtype=dtype)}] * k

    same = graph_signature(batches(2), False, None, False)
    assert graph_signature(batches(2), False, None, False) == same
    for other in (graph_signature(batches(3), False, None, False),
                  graph_signature(batches(2, (4, 256, 256, 1)), False, None,
                                  False),
                  graph_signature(batches(2, dtype=torch.bfloat16), False,
                                  None, False),
                  graph_signature(batches(2), True, None, False),
                  graph_signature(batches(2), False, 5.0, False),
                  graph_signature(batches(2), False, None, True)):
        assert other != same


@pytest.fixture
def fake_card(monkeypatch):
    """The graph path on the CPU: `_on_card` says yes, the warm-up and the
    capture run the body eagerly (a capture records the body, a replay
    runs it again) and count themselves."""
    events = []

    def warm_up(body, state, batches, noises, lrs, stream):
        events.append("warm-up")
        return body(state, batches, noises, lrs)

    class FakeGraph:
        def __init__(self, body, state, batches, noises, stream):
            events.append("capture")
            self.body, self.state, self.capture_s = body, state, 0.0

        def replay(self, params, batches, noises, lrs):
            events.append("replay")
            return self.body(self.state, batches, noises, lrs)

    monkeypatch.setattr(step_module, "_on_card", lambda model: True)
    monkeypatch.setattr(step_module, "_capture_stream", lambda device: None)
    monkeypatch.setattr(step_module, "_warm_up", warm_up)
    monkeypatch.setattr(step_module, "_TrainGraph", FakeGraph)
    return events


def test_graph_cache_by_signature(setup, fake_card):
    """The state keeps one graph: calls of its signature replay it; a new
    shape, K or `compute_metrics` warms up anew, after which the first
    signature does too; `load_state_dict` drops it."""
    micro = setup["micro"]
    want_model, _, _ = _eager_steps(setup["state_dict"], micro * 3)
    model = _port(setup["state_dict"])
    state = create_train_state(model, TOTAL_STEPS)
    multi = make_multi_train_step(model, K, clip_norm=CLIP)
    gen = torch.Generator()
    for _ in range(3):
        state, _ = multi(state, micro, gen, SEED)
    assert fake_card == ["warm-up", "capture", "replay", "replay"]
    assert state.graph[0] == graph_signature(
        [model.to_device(m) for m in micro], False, CLIP, False)
    assert state.step == 3 * K
    assert (multi.stats["eager"], multi.stats["captures"],
            multi.stats["replays"]) == (1, 1, 2)
    for name, p in want_model.state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name

    del fake_card[:]
    half = [{t: x[:1] for t, x in b.items()} for b in micro]
    multi(state, half, gen, SEED)  # a new shape
    multi(state, half, gen, SEED)
    make_multi_train_step(model, 1, clip_norm=CLIP)(state, micro[:1], gen,
                                                    SEED)  # a new K
    metrics = make_multi_train_step(model, K, compute_metrics=True,
                                    clip_norm=CLIP)
    metrics(state, micro, gen, SEED)  # compute_metrics
    assert fake_card == ["warm-up", "capture", "replay", "warm-up",
                         "warm-up"]
    for _ in range(2):
        multi(state, micro, gen, SEED)  # the first signature, warmed anew
    assert fake_card[-3:] == ["warm-up", "capture", "replay"]
    state.load_state_dict(state.state_dict())
    assert state.graph is None
    multi(state, micro, gen, SEED)
    assert fake_card[-1] == "warm-up"


def test_multi_step_under_a_mesh_stays_eager(setup, fake_card, tmp_path):
    """One gloo rank in this process: the mesh step runs the K steps
    eagerly (its all-reduce runs on the host), and equals the step
    without a mesh."""
    micro = setup["micro"]
    want_model, _, _ = _eager_steps(setup["state_dict"], micro)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, "cpu")
        model = _port(setup["state_dict"])
        state = create_train_state(model, TOTAL_STEPS)
        multi = make_multi_train_step(model, K, clip_norm=CLIP, mesh=mesh)
        state, logs = multi(state, micro, torch.Generator(), SEED)
    finally:
        dist.destroy_process_group()
    assert fake_card == [] and state.graph is None and state.step == K
    assert multi.stats["eager"] == 1
    for name, p in want_model.state_dict().items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   p.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
