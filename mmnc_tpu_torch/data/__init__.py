"""Data: the task registry, the synthetic scenes, the CLEVR contract,
prerender, the batch loader with device prefetch and the device-resident
dataset (mmnc_tpu/data). Nothing here imports PIL or torchvision until a
CLEVR file or MNIST is read."""

from .task_configs import task_parameters, SEM_CLASSES
from .synthetic import SyntheticMultiTaskDataset
from .loader import BatchLoader, prefetch_to_device
from .clevr import CLEVRDataset
from .prerender import PrerenderedDataset, prerender
from .device_cache import DeviceResidentDataset

__all__ = ["task_parameters", "SEM_CLASSES", "SyntheticMultiTaskDataset",
           "BatchLoader", "prefetch_to_device", "CLEVRDataset",
           "PrerenderedDataset", "prerender", "DeviceResidentDataset"]
