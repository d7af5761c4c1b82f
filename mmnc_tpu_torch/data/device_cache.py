"""Device-resident dataset: the whole training set lives in device memory
(mmnc_tpu/data/device_cache.py).

The dataset is uploaded once, kept quantized to 16 bits (CLEVR's on-disk
sources are 8/16-bit PNGs, so 1/65535 steps are below the source
precision), and each batch is gathered and dequantized on the device: per
batch the host moves only the batch's indices.

torch's uint16 is a storage-only dtype (`index_select` is not implemented
for it), so the 16 bits are kept in an int16 tensor holding the same bit
pattern, and widened back with `& 0xFFFF` after the gather.

Quantization and dequantization compute what mmnc_tpu's jitted float32
functions compute: XLA contracts each `a * b + c` into one fused
multiply-add (one rounding), then rounds half to even. torch has no fused
multiply-add op, so the product of two float32 values is formed exactly
in float64, the constant added there, and the sum rounded once to
float32. The dequantization's sum is exact in float64, so it equals the
fused result bitwise; the quantization's can differ from it only where
float64's rounding lands exactly on a float32 midpoint (about 2^-29 of
values). The same float64 steps run on the CPU and on the card, so both
give the same bits.
"""

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

_QUANT_LEVELS = 65535.0


def _f32(v: float) -> float:
    """A Python constant as the float32 that JAX rounds a weak-typed one
    to (returned as a Python float, which holds it exactly)."""
    return float(np.float32(v))


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product of the float32 a and b is exact in float64."""
    return (a.double() * b + c).float()


def _quantize_u16(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """round(clip(x, lo, hi) * (65535/(hi-lo)) - lo*(65535/(hi-lo))), half
    to even, as mmnc_tpu computes it; the 16 bits held in int16."""
    scale = _f32(_QUANT_LEVELS / (hi - lo))
    shift = _f32(lo * (_QUANT_LEVELS / (hi - lo)))
    q = torch.round(_fma_f32(torch.clamp(x, lo, hi), scale, -shift))
    return q.to(torch.int32).to(torch.int16)


def _dequantize_u16(q: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """u16 * ((hi-lo)/65535) + lo, as mmnc_tpu computes it, from the
    int16-held bits."""
    u16 = (q.to(torch.int32) & 0xFFFF).to(torch.float32)
    return _fma_f32(u16, _f32((hi - lo) / _QUANT_LEVELS), _f32(lo))


class DeviceResidentDataset:
    """Task-dict dataset whose arrays live on `device` (CUDA unless
    given; raises with no card and no device).

    get_batch(indices) returns {task: (B,H,W,C) float32 tensors on the
    device} from an on-device gather; BatchLoader uses it through its
    get_batch fast path, and the train loop skips its prefetch queue for
    such a dataset (`device_resident`).

    quantize=True stores 16 bits over a per-task affine range
    [min(0, floor(task min)), max(1, ceil(task max))], so [0,1] data keeps
    the full 16-bit grid and tasks beyond [0,1] on either side (semantic
    class ids 0..16, signed data) are not clipped; quantize=False stores
    the arrays as they are (float32).
    """

    # the train loop skips host-side prefetch for such datasets
    device_resident = True

    def __init__(self, arrays: Dict[str, np.ndarray], quantize: bool = True,
                 device=None):
        sizes = {t: len(a) for t, a in arrays.items()}
        assert len(set(sizes.values())) == 1, f"ragged task arrays: {sizes}"
        self.device = resolve_device(device)
        self.tasks = list(arrays)
        self.size = next(iter(sizes.values()))
        self.quantize = quantize
        self._dev = {}
        self._scales = {}
        for t, a in arrays.items():
            x = torch.as_tensor(np.asarray(a)).to(self.device)
            if quantize and x.is_floating_point():
                # per-task affine range: values beyond [0,1] on either side
                # (signed normals, class ids) survive quantization
                hi = float(max(1.0, np.ceil(float(x.max()))))
                lo = float(min(0.0, np.floor(float(x.min()))))
                self._scales[t] = (lo, hi)
                x = _quantize_u16(x, lo, hi)
            self._dev[t] = x  # the float32 upload is dropped per task

    def __len__(self):
        return self.size

    def subset_tasks(self, tasks) -> "DeviceResidentDataset":
        """A view over a task subset: shares the device tensors (no copy)."""
        view = object.__new__(DeviceResidentDataset)
        view.device = self.device
        view.tasks = list(tasks)
        view.size = self.size
        view.quantize = self.quantize
        view._dev = {t: self._dev[t] for t in tasks}
        view._scales = {t: s for t, s in self._scales.items() if t in tasks}
        return view

    def get_batch(self, indices) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.asarray(indices, np.int64)).to(self.device)
        out = {}
        for t in self.tasks:
            rows = self._dev[t].index_select(0, idx)
            if t in self._scales:
                lo, hi = self._scales[t]
                rows = _dequantize_u16(rows, lo, hi)
            out[t] = rows
        return out

    def __getitem__(self, index: int):
        batch = self.get_batch([index])
        return {t: v[0].cpu().numpy() for t, v in batch.items()}
