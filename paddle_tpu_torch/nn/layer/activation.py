"""Activation layers. Counterpart of ``paddle_tpu/nn/layer/activation.py``:
each calls its ``nn.functional`` function. Only ``PReLU`` holds a
parameter (``weight``, ``init`` everywhere); ``RReLU`` draws its slopes
while ``self.training``.
"""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from ..layer_base import Layer
from ..param_attr import make_parameter

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "ReLU", "ReLU6", "RReLU", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


class _Act(Layer):
    """``F.<_fn>(x, *self._args)``."""
    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, x):
        return getattr(F, self._fn)(x, *self._args)


def _plain(fn, cls_name):
    """A layer of ``F.fn`` with no argument (``name=`` is accepted)."""

    def __init__(self, name=None):
        _Act.__init__(self)

    return type(cls_name, (_Act,), {"_fn": fn, "__init__": __init__,
                                     "__module__": __name__})


ReLU = _plain("relu", "ReLU")
ReLU6 = _plain("relu6", "ReLU6")
Sigmoid = _plain("sigmoid", "Sigmoid")
Tanh = _plain("tanh", "Tanh")
Silu = _plain("silu", "Silu")
Swish = _plain("swish", "Swish")
Mish = _plain("mish", "Mish")
Hardswish = _plain("hardswish", "Hardswish")
Hardsigmoid = _plain("hardsigmoid", "Hardsigmoid")
LogSigmoid = _plain("log_sigmoid", "LogSigmoid")
Softsign = _plain("softsign", "Softsign")
Tanhshrink = _plain("tanhshrink", "Tanhshrink")


class GELU(_Act):
    """The erf form by default; ``approximate=True`` is the tanh form."""
    _fn = "gelu"

    def __init__(self, approximate=False, name=None):
        super().__init__(approximate)


class Hardtanh(_Act):
    _fn = "hardtanh"

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__(min, max)


class LeakyReLU(_Act):
    _fn = "leaky_relu"

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__(negative_slope)


class ELU(_Act):
    _fn = "elu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class CELU(_Act):
    _fn = "celu"

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class SELU(_Act):
    _fn = "selu"

    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__(scale, alpha)


class Softmax(_Act):
    _fn = "softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class LogSoftmax(_Act):
    _fn = "log_softmax"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class Softplus(_Act):
    _fn = "softplus"

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__(beta, threshold)


class Softshrink(_Act):
    _fn = "softshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Hardshrink(_Act):
    _fn = "hardshrink"

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class ThresholdedReLU(_Act):
    _fn = "thresholded_relu"

    def __init__(self, threshold=1.0, name=None):
        super().__init__(threshold)


class Maxout(_Act):
    _fn = "maxout"

    def __init__(self, groups, axis=1, name=None):
        super().__init__(groups, axis)


class GLU(_Act):
    _fn = "glu"

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._data_format = data_format
        self.weight = make_parameter((num_parameters,), weight_attr, dtype,
                                     False, Constant(init), device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)
