"""LeNet. Counterpart of ``paddle_tpu/vision/models/lenet.py``: the same
``features`` and ``fc`` ``Sequential``s and parameter names, for 1 x 28
x 28 images."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, device=dev), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, device=dev), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, device=dev), Linear(120, 84, device=dev),
                Linear(84, num_classes, device=dev))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
