"""Training: the two-Adam train state and the train/eval steps."""

from .state import TrainState, create_train_state, param_partition
from .step import make_eval_step, make_train_step

__all__ = ["TrainState", "create_train_state", "param_partition",
           "make_eval_step", "make_train_step"]
