"""Activations. Counterpart of ``paddle_tpu/nn/functional/activation.py``
(``gelu``, ``relu``, ``silu``, ``tanh``).

``gelu`` defaults to the exact erf form (``approximate=False``), as
paddle's does; ``approximate=True`` is the tanh form. The JAX package's
``MoELayer`` calls ``jax.nn.gelu`` with its default, the tanh form, while
ERNIE's dense FFN calls ``F.gelu`` (erf): the port keeps both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["gelu", "relu", "silu", "tanh"]


def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return TF.relu(x)


def silu(x, name=None):
    return TF.silu(x)


def tanh(x, name=None):
    return torch.tanh(x)
