"""Training's step (port of ``repro.train.step``)."""
from .step import init_train_state, make_train_step, trainable_params

__all__ = ["init_train_state", "make_train_step", "trainable_params"]
