"""MNIST / FashionMNIST as the 1-channel "mono" task: a copy of
mmnc_tpu/data/mnist.py (torchvision and PIL imported only when used).

Mirrors the reference's torchvision usage for mono runs
(src/train.py:176-183, SURVEY.md C1/L0): images resized to image_size and
scaled to [0,1]. Requires the dataset to already exist on disk
(download=False: the loader never downloads); raises a clear error
otherwise. Decoding goes straight from the torchvision raw tensors to
numpy; no torch transforms in the hot path.
"""

import numpy as np


class MNISTMonoDataset:
    def __init__(self, root: str, train: bool = True, image_size: int = 256,
                 fashion: bool = False, download: bool = False):
        import torchvision

        cls = (torchvision.datasets.FashionMNIST if fashion
               else torchvision.datasets.MNIST)
        try:
            ds = cls(root, train=train, download=download)
        except (RuntimeError, Exception) as e:  # noqa: BLE001
            raise RuntimeError(
                f"MNIST data not found under {root!r} and downloads are "
                f"disabled: {e}") from e
        self.images = np.asarray(ds.data)  # (N, 28, 28) uint8
        self.image_size = image_size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int):
        from PIL import Image

        img = Image.fromarray(self.images[index])
        img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        x = np.asarray(img, np.float32)[..., None] / 255.0
        return {"mono": x}
