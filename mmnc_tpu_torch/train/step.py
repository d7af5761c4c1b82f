"""The train step, K train steps per call and the eval step
(mmnc_tpu/train/step.py).

One train step: draw the step's noise, forward, main + aux loss, ONE
backward, an optional global-norm clip, the two-group Adam update and the
train metrics. Nothing in it waits for the device: the logs are 0-d
tensors on the device, read by the caller when it needs them. Under a
data-parallel mesh (`parallel/`) a rank's step equals the single-process
step on the global batch (`make_train_step`).

`make_multi_train_step` runs K such steps in one call. On a card the
call is one CUDA graph, the counterpart of the JAX package's one compiled
scan a dispatch (mmnc_tpu/train/step.py:88-131): the ~2000 launches of a
step are replayed without the host. The first call of a
signature (K, the micro-batches' shapes and types, the step's options,
cuDNN's determinism) runs the K steps eagerly on the capture stream: it
is a real call, and the warm-up that builds the kernels, sets their
launch attributes, lets cuDNN choose its algorithms and makes Adam's
state. The second captures the K steps into a graph and replays it; every
later call copies its micro-batches, its noise and its K main-group rates
into the graph's static inputs, replays it and copies the logs out. The
noise is drawn outside the graph, from the generator reseeded at each
micro-step's `step_seed`, exactly as K eager steps draw it (2K small
launches; it keeps the graph free of a generator's state). The graph
lives on the `TrainState`, one at a time: a call of another signature
drops it and warms up anew, and so does `load_state_dict`, which
replaces Adam's tensors. Nothing falls back: a capture or a replay that
fails raises.

Under a mesh whose device group is NCCL (`Mesh.captures`) the call is a
graph too, the counterpart of the JAX package's step jitted under a mesh
with XLA's sums inside it (mmnc_tpu/train/step.py:1-8): the gradients'
all-reduce and the logs' are captured collectives of the graph, so a
rank's call is one dispatch. Every rank warms up, captures and replays
the same calls in the same order, since a rank that captured or dropped
its graph alone would leave the others waiting in a collective: the
signature holds only what the ranks share (the mesh's size and a rank's
rows, beside what it holds without a mesh). A gloo mesh stays eager: its
collectives go through the host and cannot be captured.
`make_train_step` stays eager: it is the reference a graphed call is
held to (on the card both run one capturable Adam, which the card's
tests hold to the CPU's Adam on the same gradients).

With grad enabled every layer runs on its own (`ops/layers.py:run_layers`
fuses deconv->IGDN only under no-grad, as the JAX package trains unfused):
a train step launches the GDN kernel once per (I)GDN of the forward and
the deconv+IGDN kernel never; in a graphed call those launches are nodes
of the graph (the kernel's launch counter counts a capture once and a
replay never). The GDN backward is its closed form in torch
(`ops/gdn.py:GDNFunction`). The eval step runs under no-grad and takes
both kernels; on a card it is a CUDA graph program of the model
(`graphs.py`; under a mesh an NCCL one, with the logs' all-reduce
captured), whose capture derives the deconv taps and GDN's effective
parameters inside the graph (`ops/layers.py:_derived`), so a replay reads
the parameters a train call or a `load_state_dict` left.
"""

import contextlib
import time

import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version
from torch.utils.checkpoint import checkpoint

from .. import graphs
from ..graphs import capture_stream as _capture_stream
from ..graphs import warm_up as _warm_up
from ..ops import metrics as M
from ..ops.bound import gates_after_reduce
from ..utils import profiling
from .state import TrainState


def step_seed(seed: int, step: int) -> int:
    """The noise generator's seed for `step` of a run seeded `seed`: the
    step's noise depends on the step alone, as the JAX step folds the step
    into its key."""
    return ((seed + 1) << 32) + step


def _clip_grads(grads, max_norm: float):
    """Scale `grads` in place by min(1, max_norm / max(gnorm, 1e-12)),
    gnorm their global norm (step.py:19-28; torch's clip_grad_norm_
    divides by gnorm + 1e-6 instead). Returns gnorm, a 0-d tensor."""
    gnorm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    for g in grads:
        g.mul_(scale)
    return gnorm


@torch.no_grad()
def _step_logs(model, logs, batch, x_hats, prefix: str,
               compute_metrics: bool, mesh=None):
    """The step's logs, with per-task PSNR / MS-SSIM on x255 values
    (semantic: argmaxed, data range 17, plus mIoU) where asked, prefixed.

    Under a mesh every log is the global batch's, from one all-reduce:
    the loss logs (means over equal shards) and MS-SSIM (a mean over
    (batch, channel)) are averaged over the ranks; PSNR and mIoU are
    computed from their sufficient statistics summed over the ranks (the
    squared error and its count; per class the intersection, the union
    and the target's count), not averaged."""
    n = 1 if mesh is None else mesh.world_size
    parts = {k: v.detach().reshape(()).double() / n for k, v in logs.items()}
    data_ranges = {}
    if compute_metrics:
        for task in model.tasks:
            pred, target = x_hats[task], batch[task]
            if task == "semantic":
                pred = torch.argmax(pred, dim=-1, keepdim=True).float()
                mult, data_ranges[task] = 1.0, 17.0
                parts[f"{task}/miou_stats"] = M.miou_stats(pred[..., 0],
                                                          target[..., 0])
            else:
                mult, data_ranges[task] = 255.0, 255.0
            parts[f"{task}/psnr_stats"] = M.squared_error_stats(
                pred * mult, target * mult)
            parts[f"{prefix}/{task}/ms-ssim"] = M.ms_ssim(
                pred * mult, target * mult, data_ranges[task]).double() / n
    if mesh is not None:
        parts = mesh.all_reduce_sum(parts)
    out = {}
    for k, v in parts.items():
        task, _, kind = k.rpartition("/")
        if kind == "psnr_stats":
            out[f"{prefix}/{task}/psnr"] = M.psnr_from_stats(
                v, data_ranges[task])
        elif kind == "miou_stats":
            out[f"{prefix}/{task}/miou"] = M.miou_from_stats(v)
        else:
            out[k if "/" in k else f"{prefix}/{k}"] = v.float()
    return out


def _global_noise(model, batch, generator, mesh):
    """The noise of the global batch whose rows `batch` holds, drawn as
    a single-process step of the global batch draws it. Every rank's
    generator has the same seed, so every rank draws the same noise."""
    x = batch[model.tasks[0]]
    global_shape = (x.shape[0] * mesh.world_size, *x.shape[1:])
    return model.draw_noise(
        {model.tasks[0]: torch.empty(global_shape, device="meta")},
        generator)


def _all_reduce_gradients(grads, mesh):
    """Average `grads` over the ranks in place: one all-reduce (sum) of
    their flattened concatenation, then / N."""
    with profiling.span("train.all_reduce"):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.world_size
        for g, chunk in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(chunk.view(g.shape))


def _draw_noise(model, batch, generator, mesh):
    """The step's noise from `generator`: the batch's, or under a mesh the
    global batch's (`_global_noise`)."""
    return (model.draw_noise(batch, generator) if mesh is None
            else _global_noise(model, batch, generator, mesh))


def _rank_noise(noise, mesh):
    """The rank's rows of the global batch's noise (all of it without a
    mesh)."""
    if mesh is None:
        return noise
    rows = mesh.rows(noise["y"].shape[0])
    return {k: v[rows] for k, v in noise.items()}


def _make_update(model, compute_metrics, clip_norm, remat, mesh):
    """update(state, batch, noise, lr=None) -> logs: one step's work on a
    batch on the device, its noise (the rank's rows under a mesh) and the
    main group's rate (`TrainState.apply_gradients`). It reads nothing
    from the host, so it can be captured."""

    def loss_fn(batch, noise):
        main_loss, (logs, x_hats, _) = model.loss_and_logs(
            batch, training=True, noise=noise)
        aux = model.aux_loss()
        logs["aux_loss"] = aux
        return main_loss + aux, logs, x_hats

    params = list(model.parameters())

    def update(state, batch, noise, lr=None):
        state.optimizer.zero_grad(set_to_none=True)
        with (contextlib.nullcontext() if mesh is None
              else gates_after_reduce(params)) as gate:
            if remat:
                # the region draws no random numbers (the noise is an
                # input), so no generator state is kept for its
                # recomputation
                loss, logs, x_hats = checkpoint(loss_fn, batch, noise,
                                                use_reentrant=False,
                                                preserve_rng_state=False)
            else:
                loss, logs, x_hats = loss_fn(batch, noise)
            loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        if mesh is not None:
            _all_reduce_gradients(grads, mesh)
            gate()
        if clip_norm is not None:
            logs["grad_norm"] = _clip_grads(grads, clip_norm)
        state.apply_gradients(lr)
        return _step_logs(model, logs, batch, x_hats, "train",
                          compute_metrics, mesh)

    return update


def make_train_step(model, compute_metrics: bool = True, clip_norm=None,
                    remat: bool = False, mesh=None):
    """Returns train_step(state, batch, generator=None, noise=None) ->
    (state, logs), eager.

    The step's noise ({"z", "y"} NHWC, U(-1/2, 1/2)) is `noise` if given,
    else drawn from `generator` (a torch.Generator on the model's device).
    remat=True runs the loss under torch.utils.checkpoint (non-reentrant:
    the first pass keeps grad enabled, so it runs the same unfused layers
    as the recomputation) and the backward recomputes the forward instead
    of holding its activations. The noise is drawn before the checkpointed
    region, which does not restore a generator.

    Under a `mesh` (parallel.make_mesh) `batch` is the rank's rows of the
    global batch, and the step equals a single-process step on the global
    batch: the noise (`noise`, or drawn) is the global batch's and the
    rank keeps its rows; the gradients are averaged over the ranks after
    the backward and before the clip, which so sees the global norm; the
    GDN parameters' lower-bound gates apply to the averaged gradients
    (`ops/bound.py:gates_after_reduce`), as they apply to the global
    batch's; every rank's Adam makes the same update; the logs are the
    global batch's (`_step_logs`)."""
    update = _make_update(model, compute_metrics, clip_norm, remat, mesh)

    def train_step(state: TrainState, batch, generator=None, noise=None):
        batch = model.to_device(batch)
        if noise is None:
            if generator is None:
                raise ValueError("train_step needs a generator or noise")
            noise = _draw_noise(model, batch, generator, mesh)
        return state, update(state, batch, _rank_noise(noise, mesh))

    return train_step


def _micro_batches(super_batch, k: int):
    """A super-batch {task: (K, B, ...)} or a sequence of K batches -> the
    K batches, in order (views of the super-batch's rows, no copies)."""
    if isinstance(super_batch, dict):
        lengths = {len(x) for x in super_batch.values()}
        if lengths != {k}:
            raise ValueError(f"a super-batch of {k} micro-batches has "
                             f"leading extents {sorted(lengths)}")
        return [{t: x[i] for t, x in super_batch.items()} for i in range(k)]
    batches = list(super_batch)
    if len(batches) != k:
        raise ValueError(f"{len(batches)} micro-batches, want {k}")
    return batches


def step_noises(model, batches, generator, seed: int, step: int, mesh=None):
    """The noise of the steps step, step + 1, ... on `batches`, drawn
    ahead: before each, `generator` reseeded at step_seed(seed, step + i),
    as that many single steps of a run seeded `seed` draw it (under a mesh
    the global batch's)."""
    noises = []
    for i, batch in enumerate(batches):
        generator.manual_seed(step_seed(seed, step + i))
        noises.append(_draw_noise(model, batch, generator, mesh))
    return noises


def graph_signature(batches, compute_metrics, clip_norm, remat, mesh=None):
    """What a captured call depends on beside the model and its optimizer:
    K, each micro-batch's shapes and types, the step's options and
    whether cuDNN is deterministic (its algorithms are chosen at the
    warm-up and kept by the graph); under a mesh also its size and a
    rank's rows, which every rank shares."""
    key = (tuple(tuple((t, tuple(x.shape), x.dtype) for t, x in b.items())
                 for b in batches),
           compute_metrics, clip_norm, remat,
           torch.backends.cudnn.deterministic)
    if mesh is None:
        return key
    rows = len(next(iter(batches[0].values())))
    return key + (("mesh", mesh.world_size, rows),)


WARMED = "warmed"  # in `TrainState.graph`: warmed up, not yet captured


def _on_card(model) -> bool:
    return model.device.type == "cuda"


class _TrainGraph:
    """A captured K-step call: its static inputs (the micro-batches, their
    noise, the K main-group rates), the graph and its logs.

    The capture runs in torch's "thread_local" error mode: only this
    thread is barred from calls that are unsafe while a stream captures,
    so the prefetch thread (`data/loader.py`) may pin memory and copy on
    its own stream meanwhile."""

    def __init__(self, body, state, batches, noises, stream):
        t0 = time.perf_counter()
        self.batches = [{t: torch.empty_like(x) for t, x in b.items()}
                        for b in batches]
        self.noises = [{k: torch.empty_like(v) for k, v in n.items()}
                       for n in noises]
        self.lrs = torch.empty(len(batches), dtype=torch.float32,
                               device=stream.device)
        state.optimizer.zero_grad(set_to_none=True)
        self.graph, self.logs = graphs.capture(
            lambda: body(state, self.batches, self.noises, list(self.lrs)),
            stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self, params, batches, noises, lrs):
        """Copy the call's inputs in (device to device; the rates from
        pinned memory, without a sync), replay, mark the parameters as
        changed in place (`ops/layers.py:_derived` keys on their version),
        and return a copy of the logs, which the next replay overwrites."""
        with profiling.span("train.inputs"):
            for statics, given in ((self.batches, batches),
                                   (self.noises, noises)):
                for static, x in zip(statics, given):
                    for k, v in x.items():
                        static[k].copy_(v)
            self.lrs.copy_(torch.tensor(lrs, dtype=torch.float32,
                                        pin_memory=True), non_blocking=True)
        with profiling.span("train.replay"):
            self.graph.replay()
        with profiling.span("train.outputs"):
            for p in params:
                increment_version(p)
            return {k: v.clone() for k, v in self.logs.items()}


def make_multi_train_step(model, steps_per_call: int,
                          compute_metrics: bool = False, clip_norm=None,
                          remat: bool = False, mesh=None):
    """Returns multi_step(state, super_batch, generator=None, seed=None,
    noise=None) -> (state, logs of the last micro-step): K =
    `steps_per_call` train steps in one call (mmnc_tpu/train/step.py:
    88-131), each equal to `make_train_step`'s step.

    `super_batch` is {task: (K, B, ...)} as the JAX multi-step takes it, or
    a sequence of K batches ({task: (B, ...)}; `fit` hands it that, which
    needs no stacking copy). Micro-step i's noise is drawn from
    `generator` reseeded at step_seed(seed, state.step + i), all K before
    the first step (`step_noises`), so K steps in one call equal K single
    steps of a run seeded `seed`; `noise` ({"y", "z"} NHWC), if given, is
    every micro-step's noise instead. Micro-step i's main rate is the
    schedule's at state.step + i.

    Under a `mesh` the micro-batches are the rank's rows and every
    micro-step is the mesh step. On a card, without a mesh or under an
    NCCL one, the call is a CUDA graph (see the module's docstring): a
    warm-up call, then a capture, then replays. `multi_step.stats` counts
    its "eager" calls (warm-ups included), "captures" and "replays" (a
    capture replays too) and keeps each capture's host seconds
    ("capture_s"). On the CPU and under a gloo mesh the K steps run
    eagerly.

    While a torch profiler records, each call keeps spans
    (`utils/profiling.py`), tagged with the call's first step: train.call
    (its "steps" attribute K) and in it train.inputs (the batches to the
    device, the rates, the signature, the copies into the graph's inputs),
    train.noise (the draws), train.replay (`graph.replay()`) and
    train.outputs (the version bumps and the logs' clones)."""
    update = _make_update(model, compute_metrics, clip_norm, remat, mesh)
    params = list(model.parameters())
    graphed = _on_card(model) and (mesh is None or mesh.captures)
    stats = {"eager": 0, "captures": 0, "replays": 0, "capture_s": []}

    def body(state, batches, noises, lrs):
        logs = None
        for batch, noise, lr in zip(batches, noises, lrs):
            logs = update(state, batch, noise, lr)
        return logs

    def graphed_call(state, batches, noises, lrs):
        with profiling.span("train.inputs"):
            key = graph_signature(batches, compute_metrics, clip_norm,
                                  remat, mesh)
        stream = _capture_stream(model.device)
        if state.graph is None or state.graph[0] != key:
            state.drop_graph()
            stats["eager"] += 1
            logs = _warm_up(body, state, batches, noises, lrs, stream=stream)
            state.graph = (key, WARMED)
            return logs
        graph = state.graph[1]
        if graph is WARMED:
            graph = _TrainGraph(body, state, batches, noises, stream)
            stats["captures"] += 1
            stats["capture_s"].append(graph.capture_s)
            state.graph = (key, graph)
        stats["replays"] += 1
        return graph.replay(params, batches, noises, lrs)

    def multi_step(state: TrainState, super_batch, generator=None,
                   seed=None, noise=None):
        if noise is None and (generator is None or seed is None):
            raise ValueError("multi_step needs a generator and a seed, or "
                             "noise")
        step = state.step
        with profiling.tagged(step), profiling.span(
                "train.call", {"steps": steps_per_call}):
            with profiling.span("train.inputs"):
                batches = [model.to_device(b) for b in
                           _micro_batches(super_batch, steps_per_call)]
                lrs = state.learning_rates(steps_per_call)
            with profiling.span("train.noise"):
                noises = ([noise] * steps_per_call if noise is not None
                          else step_noises(model, batches, generator, seed,
                                           step, mesh))
                noises = [_rank_noise(n, mesh) for n in noises]
            try:
                if graphed:
                    logs = graphed_call(state, batches, noises, lrs)
                else:
                    stats["eager"] += 1
                    logs = body(state, batches, noises, lrs)
            finally:
                state.step = step
        state.step += steps_per_call
        return state, logs

    multi_step.stats = stats
    return multi_step


def eval_program(mesh=None) -> str:
    """The name of the eval step's device program (`graphs.run`): its body
    closes over the mesh, so each mesh (size, rank) has its own program."""
    if mesh is None:
        return "eval_step"
    return f"eval_step[mesh {mesh.world_size}, rank {mesh.rank}]"


def make_eval_step(model, compute_metrics: bool = True, mesh=None):
    """Returns eval_step(batch) -> logs (deterministic rounding, under
    no-grad; the parameters are the model's). Under a `mesh` `batch` is
    the rank's rows and the logs are the global batch's, as the train
    step's.

    On a card, without a mesh or under an NCCL one, the step is the
    model's device program `eval_program(mesh)` (`graphs.run`, keyed on
    `compute_metrics` and the batch's shapes): a warm-up call, a capture,
    then replays, the counterpart of the JAX package's jitted eval step
    (mmnc_tpu/train/step.py:134-146), with the logs' all-reduce captured
    under a mesh; `eval_step.stats` counts them (`graphs.stats`). Under a
    gloo mesh it runs eagerly, as the train call does (its all-reduce
    runs on the host), and counts "eager" calls only."""
    name = eval_program(mesh)
    stats = graphs.stats(model, name)

    @torch.no_grad()
    def body(batch, compute_metrics):
        batch = model.to_device(batch)
        _, (logs, x_hats, _) = model.loss_and_logs(batch, training=False)
        return _step_logs(model, logs, batch, x_hats, "val",
                          compute_metrics, mesh)

    def eval_step(batch):
        if mesh is not None and not mesh.captures:
            stats["eager"] += 1
            return body(batch, compute_metrics)
        return graphs.run(model, name, body, (batch, compute_metrics))

    eval_step.stats = stats
    return eval_step
