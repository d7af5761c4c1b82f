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

On a card Adam is `capturable`: its step counts live on the device, so
an update can be captured in a CUDA graph (`train/step.py:
make_multi_train_step`), where the main group reads its rate from its
slot of a device tensor of the call's rates. An eager update on the card
reads a 0-d device tensor too (`TrainState.device_lr`): capturable Adam
computes a float rate's update in another rounding than a tensor's, and
with both reading a tensor an eager step and a captured one are bitwise
the same (the card's tests show both facts, and hold every card update
to the CPU's Adam on the same gradients). On the CPU Adam is not
capturable (torch refuses capturable CPU parameters) and the rate is a
float. A checkpoint keeps the CPU's form on either device: the rate a
float, `capturable` off; `load_state_dict` sets `capturable` for the
state's own device, so a card's checkpoint resumes on the CPU and the
reverse.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
    schedule needs no device value).

    `device_lr` is the main group's rate for eager updates on the card
    (a 0-d float32 device tensor; None on the CPU). `graph` is the
    captured train call over this optimizer (`train/step.py`): its
    signature and the graph, or a mark that the signature was warmed up;
    None before. `load_state_dict` drops it, since it replaces the Adam
    state tensors the graph updates."""
    optimizer: torch.optim.Adam
    total_steps: int
    learning_rate_main: float
    eta_min: float
    step: int = 0
    device_lr: Optional[torch.Tensor] = None
    graph: Optional[Tuple] = field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.optimizer.param_groups[0]["params"][0].device

    def learning_rates(self, k: int = 1) -> List[float]:
        """The main group's rates of the next k updates: the schedule at
        the pre-update counts step, ..., step + k - 1, as optax takes it."""
        return [cosine_lr(self.step + i, self.total_steps,
                          self.learning_rate_main, self.eta_min)
                for i in range(k)]

    def apply_gradients(self, lr=None):
        """One update from the gradients on the parameters, the main group
        at `lr`: the schedule's at the pre-update count unless given. A
        captured update passes a 0-d float32 device tensor, which the
        graph's replays refill; on the card a float is written into
        `device_lr`, which the update reads."""
        if lr is None:
            (lr,) = self.learning_rates(1)
        main = next(g for g in self.optimizer.param_groups
                    if g["name"] == "main")
        if isinstance(lr, torch.Tensor):
            main["lr"] = lr
        elif self.device_lr is None:
            main["lr"] = float(lr)
        else:
            main["lr"] = self.device_lr.fill_(lr)
        self.optimizer.step()
        self.step += 1
        return self

    def drop_graph(self):
        """Forget the captured train call (after the card has run it: its
        memory goes back to the allocator)."""
        if self.graph is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.graph = None

    def state_dict(self) -> dict:
        """What a checkpoint keeps: the step count, the schedule's horizon
        and rates, and Adam's state (moments, counts, parameter groups),
        in the CPU's form on any device (each rate a float, `capturable`
        off)."""
        adam = self.optimizer.state_dict()
        adam["param_groups"] = [dict(g, lr=float(g["lr"]), capturable=False)
                                for g in adam["param_groups"]]
        return {"step": self.step, "total_steps": self.total_steps,
                "learning_rate_main": self.learning_rate_main,
                "eta_min": self.eta_min, "adam": adam}

    def load_state_dict(self, state: dict):
        """Restore `state_dict()`'s contents (Adam's tensors land beside
        the parameters they belong to, capturable on the card) and drop
        the captured train call."""
        self.drop_graph()
        self.step = int(state["step"])
        self.total_steps = int(state["total_steps"])
        self.learning_rate_main = float(state["learning_rate_main"])
        self.eta_min = float(state["eta_min"])
        adam = dict(state["adam"])
        capturable = self.device.type == "cuda"
        adam["param_groups"] = [dict(g, capturable=capturable)
                                for g in adam["param_groups"]]
        self.optimizer.load_state_dict(adam)
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
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    optimizer = torch.optim.Adam(
        [{"params": groups["main"], "lr": learning_rate_main, "name": "main"},
         {"params": groups["aux"], "lr": learning_rate_aux, "name": "aux"}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False,
        capturable=on_card)
    device_lr = (torch.full((), learning_rate_main, dtype=torch.float32,
                            device=device) if on_card else None)
    return TrainState(optimizer=optimizer, total_steps=total_steps,
                      learning_rate_main=learning_rate_main, eta_min=eta_min,
                      device_lr=device_lr)
