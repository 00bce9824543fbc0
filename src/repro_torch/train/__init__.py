"""Training's step and loop (port of ``repro.train``)."""
from .loop import train_loop
from .step import init_train_state, make_train_step, trainable_params

__all__ = ["init_train_state", "make_train_step", "train_loop",
           "trainable_params"]
