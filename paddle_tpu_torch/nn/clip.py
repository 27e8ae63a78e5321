"""Gradient clipping. Counterpart of ``paddle_tpu/nn/clip.py``.

Each clip takes ``[(param, grad), ...]`` (``__call__``, the optimizer's
eager step) or a ``{name: grad}`` dict (``apply_functional``, the train
step) and returns the same with clipped gradients in their own dtype.
Norms are taken in fp32; the scale is ``min(clip / max(norm, 1e-12), 1)``.

Under hybrid parallelism each rank holds blocks of some gradients. The
train step then passes ``specs`` (name -> the block's placement spec,
``distributed.mesh``): a block's squared norm is summed over the mesh
axes its spec shards (a tp-sharded gradient over the tp group, a
sharding block over the sharding group), a replicated one is counted
once, so every rank's norm is the norm of the full gradients.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        clipped = self.apply_functional(
            {i: g for i, (_, g) in enumerate(params_grads)})
        return [(p, clipped[i]) for i, (p, _) in enumerate(params_grads)]

    def apply_functional(self, grads: dict, specs=None) -> dict:
        raise NotImplementedError


def _scale(norm, clip_norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def _sharded_axes(spec):
    """The axes of size > 1 that ``spec`` shards over (() without a
    spec)."""
    if not spec:
        return ()
    from ..distributed import mesh
    m = mesh.get_mesh()
    return tuple(a for a in mesh.spec_axes(spec) if m.axis_size(a) > 1)


def _sum_over(t, axes):
    """``t`` summed in place over the mesh groups of ``axes``."""
    if axes:
        from ..distributed import collective, mesh
        m = mesh.get_mesh()
        for a in axes:
            collective.all_reduce(t, group=m.group(a))
    return t


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_functional(self, grads, specs=None):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by its own fp32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_functional(self, grads, specs=None):
        out = {}
        for k, g in grads.items():
            sq = torch.sum(g.float() ** 2)
            norm = torch.sqrt(_sum_over(sq, _sharded_axes(
                specs and specs.get(k))))
            out[k] = (g.float() * _scale(norm, self.clip_norm)).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one fp32 L2 norm taken over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads, specs=None) -> torch.Tensor:
        """The fp32 L2 norm of all gradients; with ``specs``, of the full
        gradients whose blocks this rank holds."""
        if not specs:
            return torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in grads.values()))
        parts = {}          # squared sums by the axes their blocks span
        for k, g in grads.items():
            axes = _sharded_axes(specs.get(k))
            parts[axes] = parts.get(axes, 0) + torch.sum(g.float() ** 2)
        # every rank holds the same names and specs: the same collectives
        return torch.sqrt(sum(_sum_over(parts[a], a) for a in sorted(parts)))

    def apply_functional(self, grads, specs=None):
        if not grads:
            return {}
        scale = _scale(self.global_norm(grads, specs), self.clip_norm)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place by ``min(max_norm / max(total,
    1e-12), 1)``, ``total`` the ``norm_type`` norm of all of them (fp32
    sums; ``inf`` the largest entry). Returns ``total``."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([p.grad.abs().max() for p in params]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(p.grad.float().abs() ** norm_type) for p in params])
        ) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in params:
        p.grad = (p.grad * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` to ``[-clip_value, clip_value]`` in place."""
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)
