"""The high-level API. Counterpart of ``paddle_tpu/hapi``: ``Model``,
``summary``, ``flops`` and the callbacks."""
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .dynamic_flops import flops
from .model import Model
from .model_summary import summary

__all__ = ["Callback", "EarlyStopping", "LRScheduler", "Model",
           "ModelCheckpoint", "ProgBarLogger", "VisualDL", "flops",
           "summary"]
