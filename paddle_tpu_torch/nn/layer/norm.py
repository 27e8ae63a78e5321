"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``RMSNorm``, ``LayerNorm``).

RMSNorm's arithmetic is exactly ``paddle_tpu.text.generation._rms``: mean
of squares in float32, ``rsqrt``, cast back to the input dtype, THEN
multiply by the weight (in bf16 the product rounds after the cast, as on
the JAX side). ``LayerNorm`` runs ``F.layer_norm`` with the same order.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import _no_attr, _param


def rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = _param((int(hidden_size),), Constant(1.0), device,
                             dtype)

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """Normalises over the trailing ``normalized_shape`` axes; weight
    ones and bias zeros (``weight_attr``/``bias_attr=False`` drop them)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype="float32"):
        super().__init__()
        _no_attr("LayerNorm", weight_attr=weight_attr, bias_attr=bias_attr)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = (None if weight_attr is False else _param(
            self.normalized_shape, Constant(1.0), device, dtype))
        self.bias = (None if bias_attr is False else _param(
            self.normalized_shape, Constant(0.0), device, dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"
