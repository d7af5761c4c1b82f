"""The train step, K train steps per call and the eval step
(mmnc_tpu/train/step.py).

One train step: draw the step's noise, forward, main + aux loss, ONE
backward, an optional global-norm clip, the two-group Adam update and the
train metrics. Nothing in it waits for the device: the logs are 0-d
tensors on the device, read by the caller when it needs them. Under a
data-parallel mesh (`parallel/`) a rank's step equals the single-process
step on the global batch (`make_train_step`). `make_multi_train_step`
runs K such steps, eagerly one after another, in one call.

With grad enabled every layer runs on its own (`ops/layers.py:run_layers`
fuses deconv->IGDN only under no-grad, as the JAX package trains unfused):
a train step launches the GDN kernel once per (I)GDN of the forward and
the deconv+IGDN kernel never. The GDN backward is its closed form in torch
(`ops/gdn.py:GDNFunction`). The eval step runs under no-grad and takes
both kernels.
"""

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..ops import metrics as M
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
    with torch.profiler.record_function("all_reduce_gradients"):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.world_size
        for g, chunk in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(chunk.view(g.shape))


def make_train_step(model, compute_metrics: bool = True, clip_norm=None,
                    remat: bool = False, mesh=None):
    """Returns train_step(state, batch, generator=None, noise=None) ->
    (state, logs).

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
    the backward and before the clip, which so sees the global norm, and
    every rank's Adam makes the same update; the logs are the global
    batch's (`_step_logs`)."""

    def loss_fn(batch, noise):
        main_loss, (logs, x_hats, _) = model.loss_and_logs(
            batch, training=True, noise=noise)
        aux = model.aux_loss()
        logs["aux_loss"] = aux
        return main_loss + aux, logs, x_hats

    params = list(model.parameters())

    def train_step(state: TrainState, batch, generator=None, noise=None):
        batch = model.to_device(batch)
        if noise is None:
            if generator is None:
                raise ValueError("train_step needs a generator or noise")
            noise = (model.draw_noise(batch, generator) if mesh is None
                     else _global_noise(model, batch, generator, mesh))
        if mesh is not None:
            rows = mesh.rows(noise["y"].shape[0])
            noise = {k: v[rows] for k, v in noise.items()}
        state.optimizer.zero_grad(set_to_none=True)
        if remat:
            loss, logs, x_hats = checkpoint(loss_fn, batch, noise,
                                            use_reentrant=False)
        else:
            loss, logs, x_hats = loss_fn(batch, noise)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        if mesh is not None:
            _all_reduce_gradients(grads, mesh)
        if clip_norm is not None:
            logs["grad_norm"] = _clip_grads(grads, clip_norm)
        state.apply_gradients()
        return state, _step_logs(model, logs, batch, x_hats, "train",
                                 compute_metrics, mesh)

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


def make_multi_train_step(model, steps_per_call: int,
                          compute_metrics: bool = False, clip_norm=None,
                          remat: bool = False, mesh=None):
    """Returns multi_step(state, super_batch, generator=None, seed=None,
    noise=None) -> (state, logs of the last micro-step): K =
    `steps_per_call` train steps in one call (mmnc_tpu/train/step.py:
    88-131), each `make_train_step`'s step, run eagerly one after another.

    `super_batch` is {task: (K, B, ...)} as the JAX multi-step takes it, or
    a sequence of K batches ({task: (B, ...)}; `fit` hands it that, which
    needs no stacking copy). Each micro-step draws its noise from
    `generator` reseeded at step_seed(seed, state.step) just before it, so
    K steps in one call equal K single steps of a run seeded `seed`;
    `noise` ({"y", "z"} NHWC), if given, is every micro-step's noise
    instead. Under a `mesh` the micro-batches are the rank's rows and
    every micro-step is the mesh step (the single-process step on the
    global micro-batch)."""
    one = make_train_step(model, compute_metrics=compute_metrics,
                          clip_norm=clip_norm, remat=remat, mesh=mesh)

    def multi_step(state: TrainState, super_batch, generator=None,
                   seed=None, noise=None):
        if noise is None and (generator is None or seed is None):
            raise ValueError("multi_step needs a generator and a seed, or "
                             "noise")
        logs = None
        for batch in _micro_batches(super_batch, steps_per_call):
            if noise is None:
                generator.manual_seed(step_seed(seed, state.step))
            state, logs = one(state, batch, generator, noise)
        return state, logs

    return multi_step


def make_eval_step(model, compute_metrics: bool = True, mesh=None):
    """Returns eval_step(batch) -> logs (deterministic rounding, under
    no-grad; the parameters are the model's). Under a `mesh` `batch` is
    the rank's rows and the logs are the global batch's, as the train
    step's."""

    @torch.no_grad()
    def eval_step(batch):
        batch = model.to_device(batch)
        _, (logs, x_hats, _) = model.loss_and_logs(batch, training=False)
        return _step_logs(model, logs, batch, x_hats, "val",
                          compute_metrics, mesh)

    return eval_step
