"""Loss layers. Counterpart of ``paddle_tpu/nn/layer/loss.py``
(``CrossEntropyLoss``, ``MSELoss``, ``L1Loss``; the other loss layers are
port queue item 9). Each calls its ``nn.functional`` loss."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["CrossEntropyLoss", "L1Loss", "MSELoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._args = dict(weight=weight, ignore_index=ignore_index,
                          reduction=reduction, soft_label=soft_label,
                          axis=axis, use_softmax=use_softmax,
                          label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._args)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)
