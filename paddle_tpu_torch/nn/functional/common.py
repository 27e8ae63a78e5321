"""Common functionals. Counterpart of
``paddle_tpu/nn/functional/common.py`` (``linear``, ``dropout``).

``linear`` is an amp cast site: its operands pass
``amp.maybe_cast_compute``, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import maybe_cast_compute
from ...framework.random_seed import generator

__all__ = ["linear", "dropout"]

_MODES = ("upscale_in_train", "downscale_in_infer", "downgrade_in_infer")


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``, weight ``[in, out]`` (paddle layout); under
    ``amp.auto_cast`` fp32 operands are cast to the amp dtype first."""
    x, weight = maybe_cast_compute(x, weight)
    y = x @ weight
    return y if bias is None else y + bias.to(y.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Drop each element (or each slice along ``axis``) with probability
    ``p``. The keep mask is drawn from ``framework.random_seed``'s
    generator for x's device, so ``seed(n)`` repeats it (the numbers are
    not the JAX package's). "upscale_in_train" scales the kept elements
    by ``1 / (1 - p)`` in training and is the identity otherwise;
    "downscale_in_infer" (also spelt "downgrade_in_infer") keeps them as
    they are and scales by ``1 - p`` outside training."""
    if isinstance(p, bool) or not isinstance(p, (int, float)):
        raise TypeError("dropout: p argument should be a number")
    if not 0 <= p <= 1:
        raise ValueError(f"dropout: p argument should between 0 and 1, got "
                         f"{p}")
    if mode not in _MODES:
        raise ValueError("dropout: mode should be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    upscale = mode == "upscale_in_train"
    if not training or p == 0:
        return x * (1.0 - p) if not upscale and p > 0 else x
    if p == 1:
        return x * 0.0
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = torch.rand(shape, generator=generator(x.device),
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p) if upscale else x, 0.0)
