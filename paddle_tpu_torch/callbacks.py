"""paddle.callbacks: the hapi callbacks (``hapi/callbacks.py``)."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "VisualDL"]
