"""Device selection and the numeric policy of the port."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no card and no device given this raises rather than carrying on
    on the CPU. On CUDA it applies the exact-f32 policy of the JAX package
    (mmnc_tpu/ops/layers.py:36-48): TF32 off for matmuls
    (`torch.backends.cuda.matmul.allow_tf32`) and for cuDNN convolutions
    (`torch.backends.cudnn.allow_tf32`, on by default), because a TF32
    conv moves `build_indexes` bins and so changes stream bytes.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
