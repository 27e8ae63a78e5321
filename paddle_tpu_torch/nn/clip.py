"""Gradient clipping. Counterpart of ``paddle_tpu/nn/clip.py``.

Each clip takes ``[(param, grad), ...]`` (``__call__``, the optimizer's
eager step) or a ``{name: grad}`` dict (``apply_functional``, the train
step) and returns the same with clipped gradients in their own dtype.
Norms are taken in fp32; the scale is ``min(clip / max(norm, 1e-12), 1)``.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        clipped = self.apply_functional(
            {i: g for i, (_, g) in enumerate(params_grads)})
        return [(p, clipped[i]) for i, (p, _) in enumerate(params_grads)]

    def apply_functional(self, grads: dict) -> dict:
        raise NotImplementedError


def _scale(norm, clip_norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_functional(self, grads):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by its own fp32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_functional(self, grads):
        out = {}
        for k, g in grads.items():
            norm = torch.sqrt(torch.sum(g.float() ** 2))
            out[k] = (g.float() * _scale(norm, self.clip_norm)).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one fp32 L2 norm taken over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads) -> torch.Tensor:
        return torch.sqrt(sum(torch.sum(g.float() ** 2)
                              for g in grads.values()))

    def apply_functional(self, grads):
        if not grads:
            return {}
        scale = _scale(self.global_norm(grads), self.clip_norm)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
