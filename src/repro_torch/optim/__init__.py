"""Optimizers on parameter lists (counterpart of ``repro.optim``): SGD so
far; Adam and the projection wait for ROADMAP Queue 1 item 10."""
from .sgd import SGDConfig, sgd_init, sgd_update

__all__ = ["SGDConfig", "sgd_init", "sgd_update"]
