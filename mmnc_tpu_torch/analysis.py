"""Analysis toolkit (mmnc_tpu/analysis.py): RD points from metric logs and
their plots, classical-codec baselines, per-channel bpp attribution,
latent probing, actual vs estimated bpp, and learned-codec RD points from
checkpoints.

The functions and their parameters are the JAX module's, less its
`variables` and `tables` arguments: the port's model holds its own
parameters and coding tables (`update_bottleneck_values`). Models run on
their own device; latents and reconstructions come back as tensors there.
matplotlib and PIL are imported inside the two functions that need them
(`plot_rd_curves`, `classical_codec_rd`), so nothing else here needs them.
"""

import io
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import metrics as M


# --- RD curves -------------------------------------------------------------

def load_metrics(jsonl_path: str) -> List[dict]:
    with open(jsonl_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def final_rd_point(jsonl_path: str, tasks: Sequence[str],
                   prefix: str = "val") -> dict:
    """Last logged validation entry -> {bpp, psnr/<task>, ms-ssim/<task>}."""
    records = [r for r in load_metrics(jsonl_path)
               if f"{prefix}/compression_loss" in r]
    if not records:
        raise ValueError(f"no {prefix} records in {jsonl_path}")
    r = records[-1]
    out = {"step": r["step"], "bpp": r[f"{prefix}/compression_loss"]}
    for t in tasks:
        for m in ("psnr", "ms-ssim"):
            key = f"{prefix}/{t}/{m}"
            if key in r:
                out[f"{t}/{m}"] = r[key]
    return out


def plot_rd_curves(points_by_model: Dict[str, List[dict]], task: str,
                   metric: str = "psnr", out_path: Optional[str] = None):
    """points_by_model: {label: [rd_point, ...]}; saves/returns a figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for label, pts in points_by_model.items():
        pts = sorted(pts, key=lambda p: p["bpp"])
        xs = [p["bpp"] for p in pts]
        ys = [p[f"{task}/{metric}"] for p in pts]
        ax.plot(xs, ys, marker="o", label=label)
    ax.set_xlabel("bpp")
    ax.set_ylabel(f"{task} {metric}")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


# --- classical baselines ---------------------------------------------------

def classical_codec_rd(image: np.ndarray, target_bpp: float,
                       codec: str = "JPEG", tol: float = 0.01,
                       max_iter: int = 20) -> Tuple[np.ndarray, float, int]:
    """Bisect the quality setting of JPEG/WebP to hit a target bpp.

    image: (H, W, 3) float [0,1]. Returns (decoded [0,1], achieved_bpp,
    quality).
    """
    from PIL import Image

    h, w = image.shape[:2]
    img = Image.fromarray(
        np.clip(image * 255.0, 0, 255).astype(np.uint8))

    lo, hi = 1, 100
    best = None
    for _ in range(max_iter):
        q = (lo + hi) // 2
        buf = io.BytesIO()
        img.save(buf, format=codec, quality=q)
        bpp = buf.tell() * 8 / (h * w)
        best = (buf, bpp, q)
        if abs(bpp - target_bpp) < tol:
            break
        if bpp > target_bpp:
            hi = q - 1
        else:
            lo = q + 1
        if lo > hi:
            break
    buf, bpp, q = best
    buf.seek(0)
    decoded = np.asarray(Image.open(buf).convert("RGB"), np.float32) / 255.0
    return decoded, bpp, q


# --- learned-codec baseline --------------------------------------------------

def learned_baseline_rd(checkpoint_paths: Sequence[str], batch=None,
                        batch_size: int = 16, image_size: int = 256,
                        seed: int = 21, n_images: int = 256,
                        data_style: str = "legacy", device=None
                        ) -> List[dict]:
    """RD points of trained checkpoints, for overlay on RD plots.

    Each checkpoint's codec is rebuilt and loaded on `device` (CUDA
    unless given). Each point carries the ACTUAL packed-bitstream bpp,
    both estimates of `check_bpp` and per-task PSNR/MS-SSIM, averaged
    over `n_images` held-out images (synthetic scenes of seed 10**6,
    batched by `batch_size`) weighted by batch size; pass an explicit
    `batch` to evaluate on exactly that one batch instead. `seed` is the
    JAX function's, which it does not use either."""
    from .data import BatchLoader, SyntheticMultiTaskDataset
    from .utils.checkpoint import (rebuild_model_from_checkpoint,
                                   restore_checkpoint)

    del seed
    points = []
    for path in checkpoint_paths:
        model, hp = rebuild_model_from_checkpoint(path, device)
        payload, _ = restore_checkpoint(path, model.device)
        model.load_state_dict(payload["model"])
        model.update_bottleneck_values()

        if batch is None:
            ds = SyntheticMultiTaskDataset(model.tasks, size=n_images,
                                           image_size=image_size,
                                           seed=10 ** 6, style=data_style)
            batches = list(BatchLoader(ds, batch_size, shuffle=False))
        else:
            batches = [batch]

        # the RD point averaged over every batch, weighted by its size
        acc = {}
        n_seen = 0
        for eval_batch in batches:
            eval_batch = model.to_device(eval_batch)
            bsz = eval_batch[model.tasks[0]].shape[0]
            p = check_bpp(model, eval_batch)
            x_hats, _ = model(eval_batch)
            for t in model.tasks:
                p[f"{t}/psnr"] = float(M.psnr(
                    x_hats[t] * 255.0, eval_batch[t] * 255.0, 255.0))
                p[f"{t}/ms-ssim"] = float(M.ms_ssim(
                    x_hats[t] * 255.0, eval_batch[t] * 255.0, 255.0))
            for k, v in p.items():
                acc[k] = acc.get(k, 0.0) + float(v) * bsz
            n_seen += bsz
        point = {k: v / n_seen for k, v in acc.items()}
        point["bpp"] = point["actual_bpp"]
        point["n_images"] = n_seen
        point["checkpoint"] = path
        point["lmbda"] = hp.get("lmbda")
        points.append(point)
    return points


# --- latent attribution & probing -----------------------------------------

@torch.no_grad()
def channel_bpp(model, batch) -> Dict[str, np.ndarray]:
    """Per-channel mean bpp of the y and z latents (deterministic eval).

    Returns {"y": (M,), "z": (N,), "task_slices": [(task, lo, hi), ...]}.
    The task_slices annotate which y channels belong to which task for the
    disjoint/shared variants.
    """
    _, lik = model(batch)
    b, h, w, _ = batch[model.tasks[0]].shape
    n_pix = b * h * w
    out = {}
    for name in ("y", "z"):
        bits = -torch.log2(lik[name])
        out[name] = (bits.sum(dim=(0, 1, 2)) / n_pix).cpu().numpy()
    out["task_slices"] = model.variant_slices() or []
    return out


def swap_latent_slices(model, batch_a, batch_b, channels: Sequence[int]):
    """Decode batch_a with the given y channels replaced by batch_b's.

    The shared-latent probing experiment: shows which tasks'
    reconstructions change when a latent slice is swapped. Returns
    {task: reconstruction} for the hybrid latent.
    """
    ya, za = model.encode_eval(batch_a)
    yb, _ = model.encode_eval(batch_b)
    idx = torch.as_tensor(list(channels), device=ya.device)
    y_hybrid = ya.clone()
    y_hybrid[..., idx] = yb[..., idx]
    return model.decode_from_latents(y_hybrid, za)


def average_channels(model, batch, channels: Sequence[int]):
    """Replace the given y channels with their batch mean before decoding
    (the channel-averaging ablation)."""
    y, z = model.encode_eval(batch)
    idx = torch.as_tensor(list(channels), device=y.device)
    y = y.clone()
    y[..., idx] = y[..., idx].mean(dim=0, keepdim=True)
    return model.decode_from_latents(y, z)


# --- check_bpp -------------------------------------------------------------

def check_bpp(model, batch) -> dict:
    """Actual rANS bytes vs likelihood-estimated bpp.

    Reports BOTH estimates: the training-geometry one (which under the
    reference's default legacy broadcast 16x-overcounts a saturated y
    latent, SURVEY.md §2.4 — kept, labeled, for parity with the training
    logs) and the corrected-geometry one (`corrected_geometry_twin`),
    which is the like-for-like comparator for the real bitstream. The
    coding tables are the model's (`update_bottleneck_values`)."""
    batch = model.to_device(batch)
    ans, n_bytes = model.compress(batch)
    b, h, w, _ = batch[model.tasks[0]].shape
    actual = n_bytes * 8 / (b * h * w * model.n_tasks)
    _, lik = model(batch)
    est, _ = model._compression_loss(lik, batch)
    twin = model.corrected_geometry_twin()
    _, lik_c = twin(batch)
    est_c, _ = twin._compression_loss(lik_c, batch)
    return {"actual_bpp": float(actual),
            "estimated_bpp": float(est_c),
            "estimated_bpp_legacy": float(est),
            "bytes": int(n_bytes)}
