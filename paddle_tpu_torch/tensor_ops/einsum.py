"""Einsum. Counterpart of ``paddle_tpu/tensor_ops/einsum.py``."""
from __future__ import annotations

import torch

from ._factory import operands

__all__ = ["einsum"]


def einsum(equation, *operands_, name=None):
    if len(operands_) == 1 and isinstance(operands_[0], (list, tuple)):
        operands_ = tuple(operands_[0])
    return torch.einsum(equation, *operands(*operands_))
