"""Optimizers on parameter lists (counterpart of ``repro.optim``): SGD,
Adam and the l2-ball projection."""
from .sgd import SGDConfig, sgd_init, sgd_update
from .adam import AdamConfig, adam_init, adam_update
from .projection import project_l2_ball

__all__ = ["SGDConfig", "sgd_init", "sgd_update", "AdamConfig",
           "adam_init", "adam_update", "project_l2_ball"]
