"""Training: the two-Adam train state, the train/eval steps (and K train
steps per call) and the epoch loop (`fit`: validation, checkpoints, resume)."""

from .loop import fit
from .state import TrainState, create_train_state, param_partition
from .step import make_eval_step, make_multi_train_step, make_train_step

__all__ = ["TrainState", "create_train_state", "param_partition",
           "make_eval_step", "make_multi_train_step", "make_train_step",
           "fit"]
