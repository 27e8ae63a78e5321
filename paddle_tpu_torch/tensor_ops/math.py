"""The matmul of ``paddle_tpu/tensor_ops/math.py``: the operands pass
``amp.maybe_cast_compute`` first, as in the JAX package, so under
``amp.auto_cast`` an fp32 operand is cast to the amp dtype and the
product comes out in it.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import maybe_cast_compute

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each optionally with its last two dims swapped."""
    a, b = maybe_cast_compute(x, y)
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)
