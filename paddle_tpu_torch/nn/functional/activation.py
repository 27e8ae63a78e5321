"""Activations. Counterpart of ``paddle_tpu/nn/functional/activation.py``.

Each function computes the JAX package's formula (and so its gradient):
``gelu`` defaults to the exact erf form (``approximate=False``), as
paddle's does, and ``approximate=True`` is the tanh form (the JAX
package's ``MoELayer`` calls ``jax.nn.gelu`` with its default, the tanh
form, while ERNIE's dense FFN calls ``F.gelu``, the erf form: the port
keeps both); ``rrelu`` uses the mean slope ``(lower + upper) / 2`` in
training too; ``softplus`` is linear where ``beta * x > threshold``;
``hardsigmoid`` is ``clip(x / 6 + 0.5, 0, 1)``. ``gumbel_softmax`` draws
its noise from ``framework.random_seed.generator``. The in-place forms
(``relu_``, ``elu_``, ``softmax_``, ``tanh_``) write into ``x`` and
return it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import dtype as dtype_mod
from ...framework.random_seed import generator
from ...tensor_ops._factory import floating, tensor, unary

__all__ = [
    "celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "logsigmoid", "maxout", "mish", "prelu", "relu", "relu6",
    "relu_", "rrelu", "selu", "sigmoid", "silu", "softmax", "softmax_",
    "softplus", "softshrink", "softsign", "swish", "tanh", "tanh_",
    "tanhshrink", "thresholded_relu",
]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


relu = unary(TF.relu, name="relu")
relu6 = unary(lambda x: torch.clamp(x, 0.0, 6.0), name="relu6")
sigmoid = unary(lambda x: torch.sigmoid(floating(x)), name="sigmoid")
tanh = unary(lambda x: torch.tanh(floating(x)), name="tanh")
silu = unary(TF.silu, name="silu")
swish = silu
mish = unary(lambda x: x * torch.tanh(_softplus(x)), name="mish")
hardswish = unary(lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
                  name="hardswish")
hardsigmoid = unary(lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
                    name="hardsigmoid")
tanhshrink = unary(lambda x: x - torch.tanh(x), name="tanhshrink")
softsign = unary(lambda x: x / (1 + torch.abs(x)), name="softsign")


def gelu(x, approximate=False, name=None):
    return TF.gelu(tensor(x), approximate="tanh" if approximate else "none")


def elu(x, alpha=1.0, name=None):
    x = tensor(x)
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def celu(x, alpha=1.0, name=None):
    x = tensor(x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = tensor(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def leaky_relu(x, negative_slope=0.01, name=None):
    x = tensor(x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``max(x, 0) + w * min(x, 0)`` with one slope, or one per channel
    (axis 1 for "NC..." layouts, the last otherwise)."""
    x = tensor(x)
    w = tensor(weight, x.device)
    if w.numel() == 1:
        w = w.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True, name=None):
    x = tensor(x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(tensor(x), min, max)


def hardshrink(x, threshold=0.5, name=None):
    x = tensor(x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x = tensor(x)
    return torch.sign(x) * torch.clamp(torch.abs(x) - threshold, min=0.0)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = tensor(x)
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def _cast(x, dtype):
    x = tensor(x)
    return x if dtype is None else x.to(dtype_mod.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return TF.softmax(_cast(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return TF.log_softmax(_cast(x, dtype), dim=axis)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(tensor(x))


logsigmoid = log_sigmoid


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels along ``axis``."""
    x = tensor(x)
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(tensor(x), 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise g; ``hard`` gives
    the one-hot of the argmax with the soft sample's gradient."""
    x = tensor(x)
    u = torch.empty_like(x).uniform_(generator=generator(x.device))
    g = -torch.log(-torch.log(u))
    y = TF.softmax((x + g) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, dim=axis, keepdim=True), 1.0)
        y = onehot + y - y.detach()
    return y


def thresholded_relu(x, threshold=1.0, name=None):
    x = tensor(x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def relu_(x, name=None):
    return TF.relu_(x)


def elu_(x, alpha=1.0, name=None):
    return TF.elu_(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x.tanh_()
