"""Activation layers. Counterpart of ``paddle_tpu/nn/layer/activation.py``
for the ones the port's models use (``GELU``, ``Tanh``, ``ReLU``); each
calls its ``nn.functional`` function and holds no parameter.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["GELU", "ReLU", "Tanh"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    """The erf form by default; ``approximate=True`` is the tanh form."""

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)
