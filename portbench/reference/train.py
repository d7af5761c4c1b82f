"""The train step in plain PyTorch: the reference's loss, gradients and
Adam updates of a cell's first steps.

One step: draw the step's noise, the noise-quantized forward
(`codec.Codec.loss`), the main loss plus the prior's quantile loss, one
backward, and Adam (b1 0.9, b2 0.999, eps 1e-8 after the square root,
bias-corrected) over two groups: "aux" (the prior's quantiles) at a fixed
rate, "main" (the rest) on a cosine schedule to 1e-8 over `total_steps`.
The noise is U(-1/2, 1/2), z's then y's (NHWC), drawn from a generator
on the device seeded ((seed + 1) << 32) + step, the draw the train step
of the codec defines for a run seeded `seed`.

Imports nothing of the program, of the JAX package or of JAX.
"""

import math

import torch

from . import codec

BETAS, EPS, ETA_MIN = (0.9, 0.999), 1e-8, 1e-8


def step_seed(seed: int, step: int) -> int:
    return ((seed + 1) << 32) + step


def cosine_rate(step, total_steps, lr0, eta_min=ETA_MIN):
    t = max(total_steps, 1)
    return eta_min + (lr0 - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * min(step, t) / t))


def latent_shapes(cfg, batch_size):
    """NHWC shapes of y and z: every conv pads k // 2, so a stride-2 conv
    takes an extent n to ceil(n / 2) (5 in a head, 4 in g_a, 2 in h_a)."""
    h = cfg["image_size"]
    for _ in range(9):
        h = -(-h // 2)
    zh = h
    for _ in range(2):
        zh = -(-zh // 2)
    m, _ = codec.latent_split(cfg)
    return {"y": (batch_size, h, h, m),
            "z": (batch_size, zh, zh,
                  cfg["conv_channels"] * len(cfg["tasks"]))}


def draw_noise(cfg, batch_size, seed, step, device):
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    shapes = latent_shapes(cfg, batch_size)
    return {k: torch.empty(shapes[k], device=device).uniform_(
        -0.5, 0.5, generator=gen) for k in ("z", "y")}


def run_steps(cfg, params, batches, seed, total_steps, num=None,
              alter=None):
    """`len(batches)` train steps from `params` ({name: float32 tensor},
    or float64 ones for the wide reference; updated in place) on
    `batches` ({task: NHWC}) -> (losses, the first step's gradient {name:
    tensor}, params' change {name: tensor}). `alter`, for a planted fault
    of the control, takes each step's gradients {name: tensor} before
    Adam and changes them in place."""
    num = num or codec.Numerics()
    start = {k: v.detach().clone() for k, v in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    ref = codec.Codec(cfg, params, num)
    moments = {k: (torch.zeros_like(p), torch.zeros_like(p))
               for k, p in params.items()}
    losses, first = [], None
    for step, batch in enumerate(batches):
        b = len(next(iter(batch.values())))
        device = next(iter(params.values())).device
        noise = draw_noise(cfg, b, seed, step, device)
        for p in params.values():
            p.grad = None
        loss = ref.loss(batch, noise)
        (loss + codec.aux_loss(params)).backward()
        losses.append(float(loss.detach()))
        if alter is not None:
            alter({k: p.grad for k, p in params.items()})
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        rates = {"main": cosine_rate(step, total_steps,
                                     cfg["learning_rate_main"]),
                 "aux": cfg["learning_rate_aux"]}
        t = step + 1
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                m, v = moments[k]
                m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                lr = rates["aux" if k.endswith("quantiles") else "main"]
                denom = (v.sqrt() / math.sqrt(1 - BETAS[1] ** t)).add_(EPS)
                p.addcdiv_(m, denom, value=-lr / (1 - BETAS[0] ** t))
    change = {k: p.detach() - start[k] for k, p in params.items()}
    return losses, first, change
