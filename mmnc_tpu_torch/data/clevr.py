"""Taskonomized-CLEVR dataset loader (real data, when present on disk):
a copy of mmnc_tpu/data/clevr.py. PIL is imported only where a file is
decoded, so the synthetic path never needs it.

Same on-disk contract as the reference loader (src/datasets/clevr.py:16-83,
SURVEY.md C12): files at
  <root>/<task>/<split>/point_{i}_view_0_domain_{task}.png
with splits train/val/test of 50k/5k/5k, and per-task decode rules from
the reference transforms (src/datasets/transforms.py:39-165, C14):

* rgb / normal: 8-bit -> float /255, first 3 channels
* depth_euclidean: 16-bit -> /(2^15-1), then clamp-rescale by
  task_configs clamp_to max (8000/32767)
* semantic: NEAREST-resized, G channel remapped through SEM_CLASSES to
  dense class indices, float
* resize to image_size (256), NHWC float32
"""

import os
from typing import List

import numpy as np

from .task_configs import task_parameters, SEM_CLASSES

NUM_TRAIN = 50000
NUM_VAL = 5000
NUM_TEST = 5000

_SPLIT_SIZES = {"train": NUM_TRAIN, "val": NUM_VAL, "test": NUM_TEST}


class CLEVRDataset:
    def __init__(self, data_path: str, tasks: List[str], split: str = "train",
                 image_size: int = 256):
        self.data_path = data_path
        self.tasks = list(tasks)
        self.split = split
        self.image_size = image_size
        self._sem_lut = None

    def __len__(self):
        return _SPLIT_SIZES[self.split]

    def _path(self, task: str, index: int) -> str:
        return os.path.join(
            self.data_path, task, self.split,
            f"point_{index}_view_0_domain_{task}.png")

    def _sem_remap(self, g: np.ndarray) -> np.ndarray:
        if self._sem_lut is None:
            lut = np.zeros(256, np.float32)
            for i, cls in enumerate(SEM_CLASSES):
                lut[cls] = i
            self._sem_lut = lut
        return self._sem_lut[g]

    def _load(self, task: str, index: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self._path(task, index))
        resample = Image.NEAREST if task == "semantic" else Image.BILINEAR
        if img.size != (self.image_size, self.image_size):
            img = img.resize((self.image_size, self.image_size), resample)
        arr = np.asarray(img)

        if task == "semantic":
            # 3-channel label image; G = color + 10 * material
            g = arr[..., 1] if arr.ndim == 3 else arr
            return self._sem_remap(g.astype(np.int64).clip(0, 255))[..., None]

        if task == "depth_euclidean":
            # 16-bit family (reference transform_16bit_single_channel)
            x = arr.astype(np.float32) / (2 ** 15 - 1.0)
            x = x[..., None] if x.ndim == 2 else x[..., :1]
        else:
            # 8-bit tasks
            x = arr.astype(np.float32) / 255.0
            if x.ndim == 2:
                x = x[..., None]
            if task == "principal_curvature":
                # first 2 channels (reference clevr.py:60-61 +
                # transform_8bit_n_channel(2))
                x = x[..., :2]
            elif task == "reshading":
                # channel 0 only (reference clevr.py:76-77 `x[[0]]`)
                x = x[..., :1]
            else:
                x = x[..., :3]

        # generic clamp-rescale: any task whose registry entry carries
        # clamp_to (0, maxx) is divided by maxx (reference
        # transforms.py MAKE_RESCALE_0_MAX_0_POS1)
        clamp = task_parameters.get(task, {}).get("clamp_to")
        if clamp is not None:
            minn, maxx = clamp
            assert minn == 0, "only (0, max) rescale supported (reference)"
            x = x / maxx
        return x

    def __getitem__(self, index: int):
        return {t: self._load(t, index) for t in self.tasks}
