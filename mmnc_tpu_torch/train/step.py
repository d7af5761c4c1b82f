"""The train step and the eval step (mmnc_tpu/train/step.py).

One train step: draw the step's noise, forward, main + aux loss, ONE
backward, an optional global-norm clip, the two-group Adam update and the
train metrics. Nothing in it waits for the device: the logs are 0-d
tensors on the device, read by the caller when it needs them.

With grad enabled every layer runs on its own (`ops/layers.py:run_layers`
fuses deconv->IGDN only under no-grad, as the JAX package trains unfused):
a train step launches the GDN kernel once per (I)GDN of the forward and
the deconv+IGDN kernel never. The GDN backward is its closed form in torch
(`ops/gdn.py:GDNFunction`). The eval step runs under no-grad and takes
both kernels.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import metrics as M
from .state import TrainState


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
def _metric_logs(model, batch, x_hats, prefix: str):
    """Per-task PSNR / MS-SSIM on x255 values (semantic: argmaxed, data
    range 17, plus mIoU)."""
    logs = {}
    for task in model.tasks:
        pred, target = x_hats[task], batch[task]
        if task == "semantic":
            pred = torch.argmax(pred, dim=-1, keepdim=True).float()
            mult, data_range = 1.0, 17.0
            logs[f"{prefix}/{task}/miou"] = M.miou(pred[..., 0],
                                                   target[..., 0])
        else:
            mult, data_range = 255.0, 255.0
        logs[f"{prefix}/{task}/psnr"] = M.psnr(pred * mult, target * mult,
                                               data_range)
        logs[f"{prefix}/{task}/ms-ssim"] = M.ms_ssim(pred * mult,
                                                     target * mult, data_range)
    return logs


def _prefixed(logs, prefix):
    return {k if "/" in k else f"{prefix}/{k}": v for k, v in logs.items()}


def make_train_step(model, compute_metrics: bool = True, clip_norm=None,
                    remat: bool = False):
    """Returns train_step(state, batch, generator=None, noise=None) ->
    (state, logs).

    The step's noise ({"z", "y"} NHWC, U(-1/2, 1/2)) is `noise` if given,
    else drawn from `generator` (a torch.Generator on the model's device).
    remat=True runs the loss under torch.utils.checkpoint (non-reentrant:
    the first pass keeps grad enabled, so it runs the same unfused layers
    as the recomputation) and the backward recomputes the forward instead
    of holding its activations. The noise is drawn before the checkpointed
    region, which does not restore a generator."""

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
            noise = model.draw_noise(batch, generator)
        state.optimizer.zero_grad(set_to_none=True)
        if remat:
            loss, logs, x_hats = checkpoint(loss_fn, batch, noise,
                                            use_reentrant=False)
        else:
            loss, logs, x_hats = loss_fn(batch, noise)
        loss.backward()
        if clip_norm is not None:
            logs["grad_norm"] = _clip_grads(
                [p.grad for p in params if p.grad is not None], clip_norm)
        state.apply_gradients()
        logs = {k: v.detach() for k, v in logs.items()}
        if compute_metrics:
            logs.update(_metric_logs(model, batch, x_hats, "train"))
        return state, _prefixed(logs, "train")

    return train_step


def make_eval_step(model, compute_metrics: bool = True):
    """Returns eval_step(batch) -> logs (deterministic rounding, under
    no-grad; the parameters are the model's)."""

    @torch.no_grad()
    def eval_step(batch):
        batch = model.to_device(batch)
        _, (logs, x_hats, _) = model.loss_and_logs(batch, training=False)
        if compute_metrics:
            logs.update(_metric_logs(model, batch, x_hats, "val"))
        return _prefixed(logs, "val")

    return eval_step
