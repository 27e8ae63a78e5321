"""The remaining top-level ops. Counterpart of
``paddle_tpu/tensor_ops/extras.py``: ``add_n``, ``mv``, ``sgn``,
``logcumsumexp``, ``reverse``, ``shape``, ``rank``, ``tolist``,
``create_parameter``, ``set_printoptions`` and the in-place variants.

The in-place variants (``reshape_``, ``squeeze_``, ``unsqueeze_``,
``scatter_``, ``tanh_``) change ``x`` itself and return it, as torch's
in-place ops do: autograd records them, and torch refuses them on a leaf
that requires grad (the JAX package rebinds such a leaf instead).
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device
from ._factory import floating, int_list, operands, tensor

__all__ = [
    "add_n", "create_parameter", "erfinv", "logcumsumexp", "mv", "rank",
    "reshape_", "reverse", "scatter_", "set_printoptions", "sgn", "shape",
    "squeeze_", "tanh_", "tolist", "unsqueeze_",
]


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    ts = operands(*inputs)
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def mv(x, vec, name=None):
    return torch.matmul(*operands(x, vec))


def sgn(x, name=None):
    """sign for real tensors, ``x / |x|`` (0 at 0) for complex ones."""
    x = tensor(x)
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = floating(tensor(x))
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, axis)


def reverse(x, axis, name=None):
    from .manipulation import flip
    return flip(x, axis)


def shape(x, name=None):
    """The shape as an int32 tensor (paddle.shape's dtype)."""
    x = tensor(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(x, name=None):
    x = tensor(x)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def tolist(x):
    return tensor(x).tolist()


def reshape_(x, shape, name=None):
    """``x`` reshaped in place (it must be contiguous)."""
    from .manipulation import reshape
    new = reshape(x.detach(), shape)
    if not x.is_contiguous():
        raise ValueError("reshape_ needs a contiguous tensor")
    return x.as_strided_(new.shape, new.stride(), x.storage_offset())


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    for ax in sorted({a % x.dim() for a in int_list(axis)}, reverse=True):
        if x.shape[ax] == 1:
            x.squeeze_(ax)
    return x


def unsqueeze_(x, axis, name=None):
    for ax in sorted(int_list(axis)):
        x.unsqueeze_(ax)
    return x


def scatter_(x, index, updates, overwrite=True, name=None):
    idx = tensor(index, x.device).long().reshape(-1)
    u = tensor(updates, x.device).to(x.dtype)
    if overwrite:
        return x.index_copy_(0, idx, u)
    return x.index_fill_(0, idx, 0).index_add_(0, idx, u)


def tanh_(x, name=None):
    return x.tanh_()


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone ``nn.Parameter`` on the framework's device, initialised
    as ``nn.Layer.create_parameter`` initialises one."""
    from ..nn.layer_base import make_parameter
    return make_parameter(shape, attr, dtype, is_bias, default_initializer,
                          resolve_device(None))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def erfinv(x, name=None):
    return torch.erfinv(floating(tensor(x)))


