"""``jit``: the artifact round trip (PyTorch port of ``paddle_tpu.jit``'s
``save`` / ``load``; see ``serialization.py``). A graph-carrying
artifact (``input_spec=``), ``to_static`` and the dy2static machinery are
port queue item 9."""
from __future__ import annotations

from .serialization import TranslatedLayer, load, save

__all__ = ["save", "load", "TranslatedLayer"]
