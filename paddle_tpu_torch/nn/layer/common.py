"""Common layers. Counterpart of ``paddle_tpu/nn/layer/common.py``
(``Linear``, ``Dropout``, ``Embedding``, ``Flatten``, ``Identity``).

``Linear.weight`` keeps the paddle layout ``[in, out]`` and is applied as
``x @ W + b``, so state dicts carry across without transposes. Weights
follow the JAX package's initialisers (``nn.initializer``: Xavier-uniform
weights, zero biases, N(0, 1) embeddings), drawn from
``framework.random_seed.generator(device)`` in float32 and cast to the
requested dtype. ``Dropout`` follows ``nn.Module.training``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.dtype import convert_dtype
from ...framework.random_seed import generator
from .. import functional as F
from ..initializer import Constant, Normal, XavierUniform


def _param(shape, init, device, dtype):
    dev = resolve_device(device)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    init(t, generator(dev))
    return nn.Parameter(t.to(convert_dtype(dtype) or torch.float32))


def _no_attr(layer, **attrs):
    for name, a in attrs.items():
        if a is not None and a is not False:
            raise NotImplementedError(
                f"{layer}: {name}={a!r}; the port takes None or False only "
                "(ROADMAP.md, port queue item 9: long tail)")


class Linear(nn.Module):
    """y = x @ W + b, weight ``[in, out]``; ``bias_attr=False`` drops the
    bias (zeros by default), as in the JAX package."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype="float32"):
        super().__init__()
        _no_attr("Linear", weight_attr=weight_attr, bias_attr=bias_attr)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = _param((self.in_features, self.out_features),
                             XavierUniform(), device, dtype)
        self.bias = (None if bias_attr is False else
                     _param((self.out_features,), Constant(0.0), device,
                            dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Dropout(nn.Module):
    """Zeroes elements with probability ``p`` while ``self.training``
    (``F.dropout``: "upscale_in_train" scales the kept ones by
    ``1 / (1 - p)``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Embedding(nn.Module):
    """Token lookup, weight ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.weight = _param(
            (int(num_embeddings), int(embedding_dim)), Normal(0.0, 1.0),
            device, dtype)

    def forward(self, ids):
        return self.weight[ids]

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    """Flattens the axes ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
