"""Comparison, logical and bitwise ops. Counterpart of
``paddle_tpu/tensor_ops/logic.py``. Results carry no gradient."""
from __future__ import annotations

import torch

from ._factory import binary, promoted, stop, tensor, unary

__all__ = [
    "allclose", "bitwise_and", "bitwise_left_shift", "bitwise_not",
    "bitwise_or", "bitwise_right_shift", "bitwise_xor", "equal", "equal_all",
    "greater_equal", "greater_than", "is_complex", "is_empty",
    "is_floating_point", "is_integer", "is_tensor", "isclose", "iscomplex",
    "isreal", "less_equal", "less_than", "logical_and", "logical_not",
    "logical_or", "logical_xor", "not_equal",
]

equal = binary(torch.eq, differentiable=False, name="equal")
not_equal = binary(torch.ne, differentiable=False, name="not_equal")
greater_than = binary(torch.gt, differentiable=False, name="greater_than")
greater_equal = binary(torch.ge, differentiable=False, name="greater_equal")
less_than = binary(torch.lt, differentiable=False, name="less_than")
less_equal = binary(torch.le, differentiable=False, name="less_equal")

logical_and = binary(torch.logical_and, differentiable=False,
                     name="logical_and")
logical_or = binary(torch.logical_or, differentiable=False, name="logical_or")
logical_xor = binary(torch.logical_xor, differentiable=False,
                     name="logical_xor")
logical_not = unary(torch.logical_not, differentiable=False,
                    name="logical_not")

bitwise_and = binary(torch.bitwise_and, differentiable=False,
                     name="bitwise_and")
bitwise_or = binary(torch.bitwise_or, differentiable=False, name="bitwise_or")
bitwise_xor = binary(torch.bitwise_xor, differentiable=False,
                     name="bitwise_xor")
bitwise_not = unary(torch.bitwise_not, differentiable=False,
                    name="bitwise_not")
bitwise_left_shift = binary(torch.bitwise_left_shift, differentiable=False,
                            name="bitwise_left_shift")
bitwise_right_shift = binary(torch.bitwise_right_shift, differentiable=False,
                             name="bitwise_right_shift")


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    a, b = promoted(x, y)
    same = a.shape == b.shape and bool(torch.equal(a, b))
    return torch.tensor(same, device=a.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = promoted(x, y)
    return torch.tensor(torch.allclose(a, b, rtol, atol, equal_nan),
                        device=a.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = promoted(x, y)
    return stop(torch.isclose(a, b, rtol, atol, equal_nan))


def is_empty(x, name=None):
    x = tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def isreal(x, name=None):
    return stop(torch.isreal(tensor(x)))


def iscomplex(x, name=None):
    """A 0-d bool tensor: whether ``x``'s dtype is complex."""
    x = tensor(x)
    return torch.tensor(x.is_complex(), device=x.device)


def is_complex(x):
    return tensor(x).is_complex()


def is_floating_point(x):
    return tensor(x).is_floating_point()


def is_integer(x):
    x = tensor(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)
