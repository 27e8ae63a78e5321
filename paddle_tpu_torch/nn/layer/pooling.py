"""Pooling layers. Counterpart of ``paddle_tpu/nn/layer/pooling.py``
(the ``_Pool`` layers): each holds its functional's name and keyword
arguments in ``_kw`` (where ``framework.layout.to_channels_last`` flips
``data_format``) and no parameter."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D"]


class _Pool(nn.Module):
    def __init__(self, fname, **kw):
        super().__init__()
        self._fname = fname
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._fname)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__("max_pool1d", kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         return_mask=return_mask)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__("max_pool2d", kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         return_mask=return_mask, data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__("max_pool3d", kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         return_mask=return_mask, data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__("avg_pool1d", kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__("avg_pool2d", kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__("avg_pool3d", kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    def __init__(self, output_size, name=None):
        super().__init__("adaptive_avg_pool1d", output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__("adaptive_avg_pool2d", output_size=output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__("adaptive_avg_pool3d", output_size=output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool1d", output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool2D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool2d", output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool3d", output_size=output_size,
                         return_mask=return_mask)
