"""Pooling layers. Counterpart of ``paddle_tpu/nn/layer/pooling.py``
(the ``_Pool`` layers and ``MaxUnPool1D/2D/3D``): each holds its
functional's name and keyword arguments in ``_kw`` (where
``framework.layout.to_channels_last`` flips ``data_format``) and no
parameter. With ``return_mask=True`` a max pool returns (out, mask), the
mask that ``MaxUnPool`` takes back."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class _Pool(Layer):
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


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding)
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return getattr(F, self._fn)(x, indices, *self._args,
                                    data_format=self.data_format,
                                    output_size=self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _fn = "max_unpool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPool):
    _fn = "max_unpool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool3D(_MaxUnPool):
    _fn = "max_unpool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)
