"""Losses. Counterpart of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy``, ``mse_loss``, ``l1_loss``).

``cross_entropy`` covers what the dense Llama head uses: hard integer
labels over the last axis, ``ignore_index`` and ``reduction``
("mean" averages over the labels that are not ignored). Soft labels,
class weights, label smoothing and ``use_softmax=False`` are in the
port's long tail and raise.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "l1_loss", "mse_loss"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """CE of logits ``input [..., C]`` against int ``label [...]`` (or
    ``[..., 1]``), computed in ``input``'s dtype."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing > 0 or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis, without "
            "class weights or label smoothing, are in the port yet "
            "(ROADMAP.md, port queue item 9: long tail)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    li = label.long()
    if li.dim() == input.dim():                  # [..., 1] int labels
        li = li.squeeze(-1)
    valid = li != ignore_index
    safe = torch.where(valid, li, 0)
    logp = torch.log_softmax(input, dim=-1)
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1e-12)
    return loss.sum() if reduction == "sum" else loss


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)
