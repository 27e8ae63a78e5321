"""Containers. Counterpart of ``paddle_tpu/nn/layer/container.py``
(``Sequential``, ``LayerList``).

``Sequential`` takes the JAX package's constructor forms: layers (named
``"0"``, ``"1"``, ...), ``(name, layer)`` tuples, a list of such tuples,
or an ``OrderedDict``; a slice is a new ``Sequential`` of the same
layers. ``LayerList`` is ``torch.nn.ModuleList`` with paddle's names.
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["LayerList", "Sequential"]


class Sequential(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            items = list(layers[0])
        elif len(layers) == 1 and isinstance(layers[0], OrderedDict):
            items = list(layers[0].items())
        else:
            items = [layer if isinstance(layer, tuple) else (str(i), layer)
                     for i, layer in enumerate(layers)]
        for name, layer in items:
            self.add_module(str(name), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)
