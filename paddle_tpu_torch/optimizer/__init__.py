"""Optimizers and LR schedules. Counterpart of ``paddle_tpu/optimizer``."""
from . import lr
from .algorithms import SGD, Adam, AdamW, Momentum
from .optimizer import Optimizer

__all__ = ["lr", "SGD", "Momentum", "Adam", "AdamW", "Optimizer"]
