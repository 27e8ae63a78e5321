"""Convolution layers. Counterpart of ``paddle_tpu/nn/layer/conv.py``
(``Conv2D``).

The weight is ``[out, in / groups, kh, kw]``, drawn as the JAX package
draws it: Kaiming-uniform with ``fan_in = in / groups * kh * kw`` (the
relu gain), the bias uniform in ``+-1 / sqrt(fan_in)``. ``data_format``
is "NCHW" or "NHWC" (``F.conv2d``); zero padding only, the other padding
modes are port queue item 9.
"""
from __future__ import annotations

import math

from torch import nn

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .common import _no_attr, _param


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype="float32"):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"Conv2D: data_format must be NCHW or NHWC, "
                             f"got {data_format!r}")
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D: padding_mode={padding_mode!r}; the port takes zero "
                "padding only (ROADMAP.md, port queue item 9)")
        _no_attr("Conv2D", weight_attr=weight_attr, bias_attr=bias_attr)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = False
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = _param(
            (out_channels, in_channels // groups) + self._kernel_size,
            KaimingUniform(fan_in), device, dtype)
        self.bias = (None if bias_attr is False else
                     _param((out_channels,), Uniform(-bound, bound), device,
                            dtype))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
