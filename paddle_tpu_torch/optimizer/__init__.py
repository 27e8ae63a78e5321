"""Optimizers and LR schedules. Counterpart of ``paddle_tpu/optimizer``."""
from . import lr
from .algorithms import Adam, AdamW
from .optimizer import Optimizer

__all__ = ["lr", "Adam", "AdamW", "Optimizer"]
