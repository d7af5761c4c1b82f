"""Train state with the reference's two-optimizer partition
(mmnc_tpu/train/state.py).

The reference trains with two Adams: "main" over every parameter except
the entropy-bottleneck `quantiles`, with a cosine-annealed lr, and "aux"
over the quantiles at a fixed lr. Here both are parameter groups of ONE
`torch.optim.Adam`, stepped after ONE backward pass over main + aux loss.
That is valid because

* in training the main loss never reaches `quantiles` (noise quantization
  uses no medians), and
* the aux loss detaches every density parameter,

so the gradient of the sum is block-diagonal over the partition
(tests/test_torch_train.py pins both facts).

Adam is torch's with optax's defaults, which are torch's: b1 0.9, b2
0.999, eps 1e-8 added after the square root, no weight decay, no amsgrad.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch


def param_partition(model) -> Dict[str, str]:
    """{parameter name: "aux" iff the name ends in "quantiles", else
    "main"}, in `named_parameters` order."""
    return {name: "aux" if name.endswith("quantiles") else "main"
            for name, _ in model.named_parameters()}


def cosine_lr(step: int, total_steps: int, lr0: float, eta_min: float) -> float:
    """optax.cosine_decay_schedule(lr0, total_steps, alpha=eta_min / lr0)
    at `step`: the closed form, held at eta_min from total_steps on."""
    t = max(total_steps, 1)
    decay = 0.5 * (1.0 + math.cos(math.pi * min(step, t) / t))
    return eta_min + (lr0 - eta_min) * decay


@dataclass
class TrainState:
    """One Adam over a "main" and an "aux" parameter group, the main
    group's schedule, and the count of steps taken (a host int: the
    schedule needs no device value)."""
    optimizer: torch.optim.Adam
    total_steps: int
    learning_rate_main: float
    eta_min: float
    step: int = 0

    def apply_gradients(self):
        """One update from the gradients on the parameters. As optax
        does, the main lr is the schedule's at the pre-update count."""
        for group in self.optimizer.param_groups:
            if group["name"] == "main":
                group["lr"] = cosine_lr(self.step, self.total_steps,
                                        self.learning_rate_main, self.eta_min)
        self.optimizer.step()
        self.step += 1
        return self

    def state_dict(self) -> dict:
        """What a checkpoint keeps: the step count, the schedule's horizon
        and rates, and Adam's state (moments, counts, parameter groups)."""
        return {"step": self.step, "total_steps": self.total_steps,
                "learning_rate_main": self.learning_rate_main,
                "eta_min": self.eta_min,
                "adam": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict):
        """Restore `state_dict()`'s contents (Adam's tensors land beside
        the parameters they belong to)."""
        self.step = int(state["step"])
        self.total_steps = int(state["total_steps"])
        self.learning_rate_main = float(state["learning_rate_main"])
        self.eta_min = float(state["eta_min"])
        self.optimizer.load_state_dict(state["adam"])
        return self


def create_train_state(model, total_steps: int,
                       learning_rate_main: Optional[float] = None,
                       learning_rate_aux: Optional[float] = None,
                       eta_min: float = 1e-8) -> TrainState:
    """Cosine-annealed main Adam + fixed-lr aux Adam over `model`'s
    parameters (the reference's configure_optimizers). A rate not given is
    the model's `learning_rate_main` / `learning_rate_aux`, as the
    reference's train loop passes them."""
    if learning_rate_main is None:
        learning_rate_main = model.learning_rate_main
    if learning_rate_aux is None:
        learning_rate_aux = model.learning_rate_aux
    labels = param_partition(model)
    groups = {"main": [], "aux": []}
    for name, param in model.named_parameters():
        groups[labels[name]].append(param)
    optimizer = torch.optim.Adam(
        [{"params": groups["main"], "lr": learning_rate_main, "name": "main"},
         {"params": groups["aux"], "lr": learning_rate_aux, "name": "aux"}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False)
    return TrainState(optimizer=optimizer, total_steps=total_steps,
                      learning_rate_main=learning_rate_main, eta_min=eta_min)
