"""Losses: per-task reconstruction, uncertainty weighting, rate
(mmnc_tpu/models/losses.py).

* mse/l1: summed over C, H, W, averaged over the batch, divided by C
  (i.e. MSE * H * W).
* cross-entropy: mean over pixels of the 17-class CE on dense labels.
* uncertainty weighting (no 1/2 factor): per task exp(-log_var) * loss +
  log_var, zeroed where the raw loss is 0.
* bits per pixel: sum(log lik) / -log(2) / pixels.
* the three variant rate formulas: mixed, disjoint, shared.

Pure functions on NHWC tensors; semantic targets are (B, H, W, 1) float
class indices and predictions (B, H, W, 17) logits.
"""

import math
from typing import Dict, Tuple

import torch

_LOG2 = math.log(2.0)


def reconstruction_loss(x_hat, x, loss_type: str):
    x_hat = x_hat.float()
    x = x.float()
    if loss_type == "mse":
        return torch.mean(torch.sum((x - x_hat) ** 2, dim=(1, 2, 3))) \
            / x.shape[-1]
    if loss_type == "l1":
        return torch.mean(torch.sum(torch.abs(x - x_hat), dim=(1, 2, 3))) \
            / x.shape[-1]
    if loss_type == "cross-entropy":
        labels = x[..., :1].long()
        log_p = torch.log_softmax(x_hat, dim=-1)
        return -torch.mean(torch.gather(log_p, -1, labels))
    raise NotImplementedError(f"loss_type {loss_type}")


def uncertainty_weighted_sum(task_losses: Dict[str, torch.Tensor], log_vars):
    """log_vars: (n_tasks,) in task order -> the weighted sum (0-d)."""
    losses = torch.stack(list(task_losses.values()))
    nonzero = (losses != 0.0).to(losses.dtype)
    return torch.sum((torch.exp(-log_vars) * losses + log_vars) * nonzero)


def multitask_reconstruction_loss(
        batch, x_hats, tasks, loss_types: Dict[str, str], log_vars=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    task_losses, logs = {}, {}
    for task in tasks:
        lt = loss_types[task]
        task_losses[task] = reconstruction_loss(x_hats[task], batch[task], lt)
        logs[f"{task}/{lt}"] = task_losses[task]
    if log_vars is None:
        return sum(task_losses.values()), logs
    # a copy: the parameter changes in place at the optimizer's step, and
    # the logs hold the values this loss was computed with
    logged = log_vars.detach().clone()
    for i, task in enumerate(tasks):
        logs[f"uncertainty-weight/{task}"] = logged[i]
    return uncertainty_weighted_sum(task_losses, log_vars), logs


def bits_per_pixel(likelihoods, num_pixels):
    return torch.sum(torch.log(likelihoods)) / (-_LOG2) / num_pixels


def _num_pixels(x_hats, task):
    b, h, w, _ = x_hats[task].shape
    return b * h * w


def compression_loss_mixed(likelihoods, x_hats, tasks):
    """One shared latent: total = (bpp(y) + bpp(z)) / n_tasks; every task
    logs the full bpp(y) + bpp(z)."""
    n_pix = _num_pixels(x_hats, tasks[0])
    rate = (bits_per_pixel(likelihoods["y"], n_pix)
            + bits_per_pixel(likelihoods["z"], n_pix))
    return rate / len(tasks), {f"{t}/compression_loss": rate for t in tasks}


def compression_loss_disjoint(likelihoods, x_hats, tasks, channels_per_task):
    """Per-task y channel slices; z is shared by all tasks.
    total = (sum_t bpp(y_t) + bpp(z)) / n_tasks."""
    n_pix = _num_pixels(x_hats, tasks[0])
    z_bpp = bits_per_pixel(likelihoods["z"], n_pix)
    total, logs = 0.0, {}
    for i, task in enumerate(tasks):
        sl = likelihoods["y"][..., i * channels_per_task:
                              (i + 1) * channels_per_task]
        t_bpp = bits_per_pixel(sl, n_pix)
        logs[f"{task}/compression_loss"] = t_bpp + z_bpp
        total = total + t_bpp
    return (total + z_bpp) / len(tasks), logs


def compression_loss_shared(likelihoods, x_hats, tasks, channels_per_task):
    """Disjoint slices plus one shared slice (the last channel block) whose
    rate is amortized across tasks."""
    total, logs = compression_loss_disjoint(likelihoods, x_hats, tasks,
                                            channels_per_task)
    n_pix = _num_pixels(x_hats, tasks[0])
    shared_bpp = bits_per_pixel(likelihoods["y"][..., -channels_per_task:],
                                n_pix)
    z_bpp = bits_per_pixel(likelihoods["z"], n_pix)
    logs["shared/compression_loss"] = shared_bpp + z_bpp
    return total + shared_bpp / len(tasks), logs
