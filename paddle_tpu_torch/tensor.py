"""``to_tensor`` and ``is_tensor``. Counterpart of ``paddle_tpu/tensor.py``.

The port's tensor is ``torch.Tensor`` itself (exported as
``paddle_tpu_torch.Tensor``); the paddle-named methods of the JAX
package's ``Tensor`` (``x.astype``, ``x.stop_gradient``, ...) are not
attached to it. ``to_tensor`` follows the JAX package's rules for the
data it is given: a float64 numpy array (a python float, a list of them)
becomes the default dtype (``framework.dtype.get_default_dtype``), as
does a complex128 one become complex64, unless a dtype is asked for;
integers keep their width (a python int is int64). ``place`` is a device
name ("cuda", "gpu:0", "cpu") or a ``torch.device``; without one the
tensor goes to the framework's device (``set_device``), CUDA unless told
otherwise, and asking for CUDA on a machine without it raises.
``stop_gradient=False`` is ``requires_grad=True`` (for floating and
complex dtypes; integer tensors carry no gradient in torch).
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import dtype as dtype_mod
from .framework.device import resolve_device

Tensor = torch.Tensor
Parameter = torch.nn.Parameter

__all__ = ["Parameter", "Tensor", "is_tensor", "to_tensor"]


def _host_array(data):
    """``data`` (scalar, nested list, numpy array, tensors inside a list)
    as a numpy array on the host."""
    if isinstance(data, (list, tuple)) and any(
            isinstance(d, torch.Tensor) for d in data):
        return np.stack([_host_array(d) for d in data])
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new tensor holding a copy of ``data``."""
    dev = resolve_device(place)
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, dt or data.dtype, copy=True)
    else:
        arr = _host_array(data)
        if dt is None and arr.dtype == np.float64:
            dt = dtype_mod.default_dtype()
        elif dt is None and arr.dtype == np.complex128:
            dt = torch.complex64
        t = torch.tensor(arr).to(dev, dt)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
