"""Self-describing checkpoints with auto-resume discovery
(mmnc_tpu/utils/checkpoint.py).

Layout, the JAX package's with a torch state in place of orbax's:

    <dir>/step_<N>/hyper_parameters.json   the model's hyper_parameters
                                           plus "total_steps"
    <dir>/step_<N>/state.pt                torch.save of {"step", "model":
                                           the model's state_dict,
                                           "optimizer": the TrainState's}

The model is rebuilt from hyper_parameters.json alone, and the rebuild
also reads a hyper_parameters.json written by mmnc_tpu (the same keys).
"""

import json
import os
import re
from typing import Optional, Tuple

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, model, state,
                    hyper_parameters: dict) -> str:
    """Write step_<step>/ under ckpt_dir; returns its path. The state file
    is written under a temporary name and moved into place, so a reader
    never sees half of it."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "hyper_parameters.json"), "w") as f:
        json.dump(hyper_parameters, f, indent=2)
    target = os.path.join(path, STATE_FILE)
    torch.save({"step": int(step), "model": model.state_dict(),
                "optimizer": state.state_dict()}, target + ".tmp")
    os.replace(target + ".tmp", target)
    return path


def find_last_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Latest step_<N> directory under ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def restore_checkpoint(path: str, device) -> Tuple[dict, dict]:
    """-> (payload {step, model, optimizer}, hyper_parameters); tensors
    land on `device` (the model's)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "hyper_parameters.json")) as f:
        hp = json.load(f)
    payload = torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                         map_location=device)
    return payload, hp


def rebuild_model_from_checkpoint(path: str, device=None):
    """Reconstruct the codec from hyper_parameters.json alone (as the
    reference's compress.py rebuilds from ckpt["hyper_parameters"]), on
    `device` (CUDA unless given). -> (model, hyper_parameters)."""
    from ..models.codecs import MODEL_NAME

    with open(os.path.join(path, "hyper_parameters.json")) as f:
        hp = json.load(f)
    cls = MODEL_NAME[hp["model_class"]]
    return cls(
        tasks=tuple(hp["tasks"]),
        input_channels=tuple(hp["input_channels"]),
        output_channels=tuple(hp["output_channels"]),
        latent_channels=hp["latent_channels"],
        conv_channels=hp["conv_channels"],
        lmbda=hp["lmbda"],
        learning_rate_main=hp["learning_rate_main"],
        learning_rate_aux=hp["learning_rate_aux"],
        legacy_broadcast=hp.get("legacy_broadcast", True),
        device=device,
    ), hp
