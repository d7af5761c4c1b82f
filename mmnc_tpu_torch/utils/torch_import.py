"""Import reference (CompressAI / Lightning) checkpoints into a port codec
(mmnc_tpu/utils/torch_import.py).

The port's modules carry the reference's state_dict names and layouts
(convs (O, I, kh, kw), transposed convs (I, O, kh, kw), GDN beta and
gamma in CompressAI's reparametrised space; models/heads.py), so an
import is a copy by name with no layout conversion. It reads the keys
the JAX importer reads:

* every conv, transposed conv and GDN of the input heads, g_a, g_s (the
  mixed codecs), h_a, h_s and the output heads (a disjoint/shared head's
  upsample stack at `output_heads.{t}.0-6`, its decoder head nested at
  `.7`); a missing key raises KeyError naming it;
* the entropy bottleneck's `_matrix{k}` and `_bias{k}` where the
  state_dict has `_matrix0`, its `_factor{k}` and `quantiles` where it has
  them (the model keeps its own values otherwise);
* `loss_balancer.log_vars` where the state_dict has it (a model that
  does not weight its tasks by uncertainty has none, and skips it).

Every other key is skipped: CompressAI's buffers (the entropy
bottleneck's `_offset`, `_quantized_cdf` and `_cdf_length`, the Gaussian
conditional's `scale_table` and the rest, the GDN reparametrisers'
`pedestal` and `lower_bound.bound`) and anything else. `raw_gdn=True`
takes beta and gamma as effective values and reparametrises them
(`ops.layers.nonneg_init`), as the JAX importer does.
"""

from typing import Mapping

import torch

from ..ops.layers import GDN, nonneg_init

_EB = "model.compressor.entropy_bottleneck."
_LOG_VARS = "loss_balancer.log_vars"


def _required(key: str, state_dict: Mapping) -> bool:
    """Whether `state_dict` must hold the port's parameter `key`."""
    if key.startswith(_EB):
        name = key[len(_EB):]
        if name.startswith(("_matrix", "_bias")):
            return _EB + "_matrix0" in state_dict
        return False  # _factor{k}, quantiles
    return key != _LOG_VARS


@torch.no_grad()
def import_reference_state_dict(state_dict: Mapping, model,
                                raw_gdn: bool = False):
    """Load a reference-named state_dict, or a Lightning checkpoint
    ({"state_dict": ...}), into the port codec `model` in place; returns
    `model`. Its coding tables are dropped: call
    `update_bottleneck_values()` before coding."""
    if isinstance(state_dict.get("state_dict"), Mapping):
        state_dict = state_dict["state_dict"]
    gdn_keys = {f"{name}.{p}" for name, module in model.named_modules()
                if isinstance(module, GDN) for p in ("beta", "gamma")}
    current = model.state_dict()
    for key in current:
        if key not in state_dict:
            if _required(key, state_dict):
                raise KeyError(key)
            continue
        value = torch.as_tensor(state_dict[key]).detach().to(
            "cpu", torch.float32)
        current[key] = nonneg_init(value) if raw_gdn and key in gdn_keys \
            else value
    model.load_state_dict(current)  # raises on a shape the model lacks
    model.tables = None
    return model
