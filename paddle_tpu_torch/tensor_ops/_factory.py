"""Argument normalisers shared by the ops. Counterpart of
``paddle_tpu/tensor_ops/_factory.py`` (``unary``, ``binary``,
``reduction``; ``dims`` is its ``reduce_axis``).

An op takes tensors, python scalars, numpy arrays and nested lists.
Arrays and lists become tensors by ``to_tensor``'s rules on the device
of the op's tensor operands (the framework's device when there is none).
A python scalar next to a tensor becomes a 0-d tensor, which torch
promotes as JAX promotes a weakly typed scalar: it changes the result
dtype only across kinds (an int32 tensor times 2.5 is float32, a bf16
tensor plus 1.0 stays bf16). A non-differentiable op (comparisons,
``floor_divide``, index results) returns a tensor that carries no
gradient, as the JAX package's ``nondiff`` does.
"""
from __future__ import annotations

import builtins
import numbers

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device


def device_of(*xs):
    """The device of the first tensor among ``xs`` (lists searched), else
    the framework's device."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    return y.device
    return resolve_device(None)


def _scalar_dtype(v):
    if isinstance(v, (bool, np.bool_)):
        return torch.bool
    if isinstance(v, numbers.Integral):
        return torch.int64
    if isinstance(v, numbers.Complex) and not isinstance(v, numbers.Real):
        return torch.complex64
    return dtype_mod.default_dtype()


def tensor(x, device=None, dtype=None):
    """``x`` as a tensor: a tensor as it is (cast to ``dtype`` if given),
    a python scalar as a 0-d tensor, anything else by ``to_tensor``'s
    rules, on ``device`` (the framework's device when None)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype_mod.convert_dtype(dtype))
    dev = device if device is not None else resolve_device(None)
    if isinstance(x, (numbers.Number, np.bool_)) and not isinstance(
            x, np.ndarray):
        dt = dtype_mod.convert_dtype(dtype) or _scalar_dtype(x)
        return torch.tensor(x, dtype=dt, device=dev)
    from ..tensor import to_tensor
    return to_tensor(x, dtype=dtype, place=dev)


def operands(*xs):
    """Every argument as a tensor on the device of the tensor ones."""
    dev = device_of(*xs)
    return tuple(tensor(x, dev) for x in xs)


def promoted(*xs):
    """The arguments as tensors of their promoted dtype (for torch ops
    that take only equal dtypes)."""
    ts = operands(*xs)
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def floating(x):
    """``x`` cast to the default float dtype when it is not floating or
    complex (JAX's transcendental ops on integers)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.default_dtype())


def stop(out):
    """A result that carries no gradient (the JAX package's ``nondiff``):
    tensors detached, tuples and lists element by element."""
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (tuple, list)):
        return type(out)(stop(o) for o in out)
    return out


def unary(tfn, differentiable=True, name=None):
    """A paddle op ``op(x, name=None)`` over ``tfn(tensor)``."""
    def op(x, name=None):
        out = tfn(tensor(x))
        return out if differentiable else stop(out)
    op.__name__ = op.__qualname__ = name or getattr(tfn, "__name__", "op")
    return op


def binary(tfn, differentiable=True, name=None):
    """A paddle op ``op(x, y, name=None)`` over ``tfn(tensor, tensor)``."""
    def op(x, y, name=None):
        out = tfn(*operands(x, y))
        return out if differentiable else stop(out)
    op.__name__ = op.__qualname__ = name or getattr(tfn, "__name__", "op")
    return op


def dims(axis, ndim):
    """paddle's reduction axis as a tuple of non-negative dims: None or
    ``[]`` (every axis), an int, a list or tuple, or a tensor of axes."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if axis is None or (isinstance(axis, (list, tuple)) and not axis):
        return tuple(range(ndim))
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    return tuple(int(a) % builtins.max(ndim, 1) for a in axes)


def reduction(tfn, dtype_slot=None, name=None):
    """paddle reductions: ``tfn(x, dims, keepdim)`` with ``dims`` a tuple.
    ``dtype`` sits where the reference signature has it (sum/nansum:
    ``(x, axis, dtype, keepdim)``; prod: ``(x, axis, keepdim, dtype)``;
    the others have none)."""
    def impl(x, axis, keepdim, dtype):
        x = tensor(x)
        if dtype is not None:
            x = x.to(dtype_mod.convert_dtype(dtype))
        return tfn(x, dims(axis, x.dim()), keepdim)

    if dtype_slot == "before_keepdim":
        def op(x, axis=None, dtype=None, keepdim=False, name=None):
            return impl(x, axis, keepdim, dtype)
    elif dtype_slot == "after_keepdim":
        def op(x, axis=None, keepdim=False, dtype=None, name=None):
            return impl(x, axis, keepdim, dtype)
    else:
        def op(x, axis=None, keepdim=False, name=None):
            return impl(x, axis, keepdim, None)
    op.__name__ = op.__qualname__ = name or getattr(tfn, "__name__",
                                                    "reduce")
    return op


def as_int(v):
    """int() of a python int, a 0-d or 1-element tensor or array (the
    reference takes tensor scalars in shapes, axes and indices)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise TypeError(f"expected a scalar, got shape {tuple(v.shape)}")
        return int(v.reshape(()).item())
    arr = np.asarray(v)
    if arr.ndim > 0:
        if arr.size != 1:
            raise TypeError(f"expected a scalar, got shape {arr.shape}")
        arr = arr.reshape(())
    return int(arr)


def int_list(v):
    """A shape-like argument (an int, a sequence of ints and tensor
    scalars, a 1-D tensor or array) as a list of ints."""
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    if isinstance(v, np.ndarray):
        return [int(i) for i in v.reshape(-1)]
    if isinstance(v, (list, tuple)):
        return [as_int(i) for i in v]
    return [as_int(v)]
