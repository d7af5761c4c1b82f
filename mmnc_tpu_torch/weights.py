"""Carry mmnc_tpu params (a flax params pytree of numpy arrays) into a port
state_dict — the inverse of mmnc_tpu/utils/torch_import.py.

Layout conversions:
    Conv   (kh,kw,I,O)                -> (O,I,kh,kw)   transpose
    Deconv (kh,kw,I,O), flipped taps  -> (I,O,kh,kw)   flip (kh,kw), transpose
    GDN beta/gamma                    -> copied in reparam space
    EntropyBottleneck matrix_k/bias_k/factor_k/quantiles
                                      -> _matrix{k}/_bias{k}/_factor{k}/quantiles
"""

from typing import Dict

import numpy as np
import torch

from .ops.layers import Conv, Deconv


def _layout(kinds):
    return dict(enumerate(kinds))


# {seq index in the torch Sequential: kind}, as mmnc_tpu's importer reads them
_ENC_HEAD = _layout(["conv", "gdn"] * 6)
_DEC_HEAD = _layout(["deconv", "gdn", "conv", "gdn", "deconv", "gdn",
                     "conv", "gdn", "deconv", "gdn", "deconv", "gdn", "conv"])
_G_A = _layout(["conv", "gdn", "conv", "gdn", "conv", "gdn", "conv"])
_G_S = _layout(["deconv", "gdn", "deconv", "gdn", "deconv", "gdn", "deconv"])
_UPSAMPLE = _G_S  # a disjoint/shared head's upsample stack: the same layers
_H_A = {0: "conv", 2: "conv", 4: "conv"}
_H_S = {0: "deconv", 2: "deconv", 4: "conv"}
_FLAX_NAME = {"conv": "Conv", "deconv": "Deconv", "gdn": "GDN"}


def conv_weight_from_jax(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def deconv_weight_from_jax(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1))


def _sequential(prefix: str, tree: Dict, layout: Dict[int, str], sd: Dict):
    counters = {"conv": 0, "deconv": 0, "gdn": 0}
    for seq in sorted(layout):
        kind = layout[seq]
        node = tree[f"{_FLAX_NAME[kind]}_{counters[kind]}"]
        counters[kind] += 1
        if kind == "gdn":
            sd[f"{prefix}.{seq}.beta"] = node["beta"]
            sd[f"{prefix}.{seq}.gamma"] = node["gamma"]
        else:
            convert = (conv_weight_from_jax if kind == "conv"
                       else deconv_weight_from_jax)
            sd[f"{prefix}.{seq}.weight"] = convert(node["kernel"])
            sd[f"{prefix}.{seq}.bias"] = node["bias"]


# Gains on the conv kernels of a freshly drawn model: at the init scale
# every y of the untrained codec rounds to 0 and the decode is all zeros.
# Scaled (encoder 4, hyperprior 10, decoder 3), the bench config codes
# non-zero y and z symbols (on the CPU 43% and 36% of them), spread scale
# indexes and an O(1) reconstruction.
ENCODER_GAIN, HYPER_GAIN, DECODER_GAIN = 4.0, 10.0, 3.0


@torch.no_grad()
def scale_conv_kernels(model):
    """Multiply a port codec's conv and deconv kernels in place: h_a/h_s by
    HYPER_GAIN, g_s and the output heads by DECODER_GAIN, the rest (input
    heads, g_a) by ENCODER_GAIN. Returns the model."""
    for name, module in model.named_modules():
        if isinstance(module, (Conv, Deconv)):
            if ".h_a." in name or ".h_s." in name:
                module.weight.mul_(HYPER_GAIN)
            elif ".g_s." in name or "output_heads" in name:
                module.weight.mul_(DECODER_GAIN)
            else:
                module.weight.mul_(ENCODER_GAIN)
    return model


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX params (without the {"params": ...} wrapper) of any of the four
    codecs -> the port's state_dict (float32 CPU tensors).

    A disjoint/shared output head is `upsamples_{t}` (-> output_heads.{t}
    .0-6) then `output_heads_{t}` (-> output_heads.{t}.7.*); g_s only
    where the params hold one (mixed); `log_vars` -> loss_balancer.log_vars.
    """
    sd: Dict = {}
    n_tasks = sum(1 for k in params if k.startswith("input_heads_"))
    for t in range(n_tasks):
        _sequential(f"model.input_heads.{t}", params[f"input_heads_{t}"],
                    _ENC_HEAD, sd)
        head = f"model.output_heads.{t}"
        if f"upsamples_{t}" in params:
            _sequential(head, params[f"upsamples_{t}"], _UPSAMPLE, sd)
            head += ".7"
        _sequential(head, params[f"output_heads_{t}"], _DEC_HEAD, sd)
    comp = params["compressor"]
    for name, layout in (("g_a", _G_A), ("g_s", _G_S), ("h_a", _H_A),
                         ("h_s", _H_S)):
        if name in comp:
            _sequential(f"model.compressor.{name}", comp[name], layout, sd)
    eb = comp["entropy_bottleneck"]
    prefix = "model.compressor.entropy_bottleneck"
    for key, value in eb.items():
        if key == "quantiles":
            sd[f"{prefix}.quantiles"] = value
        else:
            kind, k = key.rsplit("_", 1)
            sd[f"{prefix}._{kind}{k}"] = value
    if "log_vars" in params:
        sd["loss_balancer.log_vars"] = params["log_vars"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
