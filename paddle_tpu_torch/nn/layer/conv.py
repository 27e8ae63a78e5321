"""Convolution layers. Counterpart of ``paddle_tpu/nn/layer/conv.py``
(``Conv1D``, ``Conv2D``, ``Conv3D`` and the three transposed ones).

The weight is ``[out, in / groups, *k]`` (a transposed convolution's
``[in, out / groups, *k]``), drawn as the JAX package draws it:
Kaiming-uniform with ``fan_in = in / groups * prod(k)`` (the relu gain),
the bias uniform in ``+-1 / sqrt(fan_in)``, unless a ``ParamAttr`` names
another initialiser. A ``padding_mode`` other than "zeros" pads the
input with ``F.pad`` in that mode and runs the convolution unpadded, as
the JAX package does.
"""
from __future__ import annotations

import math

from .. import functional as F
from ..functional.conv import _norm_tuple
from ..initializer import KaimingUniform, Uniform
from ..layer_base import Layer
from ..param_attr import make_parameter

__all__ = ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        if padding_mode not in ("zeros", "reflect", "replicate",
                                "circular"):
            raise ValueError(f"padding_mode must be zeros, reflect, "
                             f"replicate or circular, got {padding_mode!r}")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._n = n
        self._transpose = transpose
        self._output_padding = output_padding
        self._padding_mode = padding_mode
        if padding_mode != "zeros":
            pads = _norm_tuple(padding, n)
            if len(pads) == 2 * n:          # flattened per-side pairs
                pads = [(int(pads[2 * i]), int(pads[2 * i + 1]))
                        for i in range(n)]
            else:
                pads = [(int(p), int(p)) for p in pads]
            self._pre_pad = [v for lo_hi in reversed(pads) for v in lo_hi]
            self._padding = 0
        shape = ((in_channels, out_channels // groups) if transpose
                 else (out_channels, in_channels // groups))
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = make_parameter(shape + self._kernel_size, weight_attr,
                                     dtype, False, KaimingUniform(fan_in),
                                     device)
        self.bias = make_parameter((out_channels,), bias_attr, dtype, True,
                                   Uniform(-bound, bound), device)

    def _maybe_pre_pad(self, x):
        if self._padding_mode == "zeros":
            return x
        return F.pad(x, self._pre_pad, mode=self._padding_mode,
                     data_format=self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class _Conv(_ConvNd):
    _fn = None

    def forward(self, x):
        return getattr(F, self._fn)(
            self._maybe_pre_pad(x), self.weight, self.bias, self._stride,
            self._padding, self._dilation, self._groups, self._data_format)


class Conv1D(_Conv):
    _fn = "conv1d"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)


class Conv2D(_Conv):
    _fn = "conv2d"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype="float32"):
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"Conv2D: data_format must be NCHW or NHWC, "
                             f"got {data_format!r}")
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)


class Conv3D(_Conv):
    _fn = "conv3d"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)


class _ConvTranspose(_ConvNd):
    _fn = None

    def forward(self, x, output_size=None):
        return getattr(F, self._fn)(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size,
            self._data_format)


class Conv1DTranspose(_ConvTranspose):
    _fn = "conv1d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device, dtype)


class Conv2DTranspose(_ConvTranspose):
    _fn = "conv2d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device, dtype)


class Conv3DTranspose(_ConvTranspose):
    _fn = "conv3d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype="float32"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device, dtype)
