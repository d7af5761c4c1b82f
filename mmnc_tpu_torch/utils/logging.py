"""Metric sink and qualitative image dumps (mmnc_tpu/utils/logging.py).

Scalars go to a JSONL file (+stdout), one record per call with the same
keys as the JAX package's ({"step", "time", **scalars}), and to wandb
when it is installed and asked for. `save_image_grid` writes one PNG per
task (predictions over targets) with the same pixels as the JAX
package's, encoded here with zlib so that no image library is needed.
"""

import json
import os
import struct
import time
import zlib
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run",
                 use_wandb: bool = False, print_every: int = 50):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")
        self.print_every = print_every
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
            except ImportError:
                print("wandb requested but not installed; logging to JSONL only")

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": int(step), "time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.log(scalars, step=step)
        if self.print_every and step % self.print_every == 0:
            keys = [k for k in ("train/loss", "val/loss", "train/rec_loss",
                                "train/compression_loss", "train/aux_loss")
                    if k in scalars]
            brief = " ".join(f"{k.split('/')[-1]}={scalars[k]:.4g}" for k in keys)
            print(f"[{rec['time']:7.1f}s] step {step}: {brief}")

    def close(self):
        self._f.close()


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray):
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG: signature, IHDR, one
    zlib-compressed IDAT of filter-0 scanlines, IEND."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def save_image_grid(path: str, x_hats: Dict[str, np.ndarray],
                    targets: Dict[str, np.ndarray], max_items: int = 8):
    """Write one PNG per task: top row predictions, bottom row targets
    (the reference callback's 8-sample qualitative dump)."""
    os.makedirs(path, exist_ok=True)
    for task, pred in x_hats.items():
        pred = np.asarray(pred)
        targ = np.asarray(targets[task])
        if task == "semantic":
            if pred.shape[-1] > 1:
                pred = np.argmax(pred, -1)[..., None] / 17.0
            targ = targ / 17.0
        n = min(max_items, pred.shape[0])
        p = _to_uint8(pred[:n])
        t = _to_uint8(targ[:n])
        if p.shape[-1] == 1:
            p = np.repeat(p, 3, -1)
            t = np.repeat(t, 3, -1)
        p = p[..., :3]
        t = t[..., :3]
        row_p = np.concatenate(list(p), axis=1)
        row_t = np.concatenate(list(t), axis=1)
        grid = np.concatenate([row_p, row_t], axis=0)
        write_png(os.path.join(path, f"{task}.png"), grid)
