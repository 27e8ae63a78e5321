"""Fused LM-head linear + cross entropy. Counterpart of
``paddle_tpu/nn/functional/fused_ce.py``.

``fused_linear_cross_entropy(hidden, weight, labels, chunk_size)`` is the
mean CE of ``hidden @ weight`` against int ``labels`` without the
``[N, V]`` logits. It runs through ``ops.fused_ce.fused_ce_loss`` on
every device: on CUDA the fused-CE kernel computes, in one pass, the
online log-sum-exp that the JAX package's chunk scan computes; on the CPU
its plain version walks the vocabulary in chunks. ``chunk_size`` sets the
vocabulary width of the backward's chunks, which rebuild each chunk's
logits from the saved stats (the JAX scan's ``jax.checkpoint``).
"""
from __future__ import annotations

from ...ops.fused_ce import fused_ce_loss

__all__ = ["fused_linear_cross_entropy"]


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192,
                               tp_group=None):
    """Mean CE of ``hidden @ weight`` against int ``labels`` without
    materializing the ``[N, V]`` logits. hidden ``[..., H]``, weight
    ``[H, V]``, labels ``[...]`` int; returns a scalar fp32 tensor. With a
    ``tp_group`` of several ranks, ``weight`` is this rank's ``[H, V/tp]``
    column shard (``ops.fused_ce.fused_ce_loss``'s ``group``)."""
    return fused_ce_loss(hidden.reshape(-1, hidden.shape[-1]), weight,
                         labels.reshape(-1), int(chunk_size), tp_group)
