"""Containers. Counterpart of ``paddle_tpu/nn/layer/container.py``
(``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``).

``Sequential`` takes the JAX package's constructor forms: layers (named
``"0"``, ``"1"``, ...), ``(name, layer)`` tuples, a list of such tuples,
or an ``OrderedDict``; a slice is a new ``Sequential`` of the same
layers. ``LayerList``, ``LayerDict`` and ``ParameterList`` are
``nn.Layer``s with ``torch.nn.ModuleList`` / ``ModuleDict`` /
``ParameterList``'s behaviour and paddle's names; their ``state_dict``
keys ("0.weight", "enc.weight", "0") are the JAX package's.
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from ..layer_base import Layer

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]


class Sequential(Layer):
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


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for p in parameters:
                self.append(p)
