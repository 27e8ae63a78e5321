"""Normalisation functionals. Counterpart of
``paddle_tpu/nn/functional/norm.py:layer_norm``.

The arithmetic is the JAX package's: mean and (population) variance in
float32 over the normalised axes, the normalised value cast back to x's
dtype, THEN times the weight, then plus the bias (in bf16 each step
rounds as on the JAX side).
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    dims = tuple(range(x.dim() - len(ns), x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
