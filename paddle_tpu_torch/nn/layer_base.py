"""``nn.Layer`` and ``ParamAttr``. Counterpart of
``paddle_tpu/nn/layer_base.py``.

``Layer`` is a ``torch.nn.Module`` with paddle's surface on top:
``create_parameter`` (the JAX package's default initialisers,
Xavier-uniform weights and zero biases, unless a ``ParamAttr`` or a
default initialiser says otherwise), ``add_parameter``,
``add_sublayer``, ``register_buffer(persistable=)``, ``parameters()`` as
a list, ``named_parameters``, ``buffers``, ``sublayers``,
``named_sublayers``, ``apply`` (self first, then every sublayer),
``state_dict``/``set_state_dict`` with the JAX package's keys, ``to(dtype=)``,
``astype``, the forward pre/post hooks (``remove()`` on the handle),
``clear_gradients`` and ``full_name``. Every layer of ``nn/layer/`` is
a ``Layer``; the walkers also take any other ``torch.nn.Module`` child
(the models of ``text/`` and ``vision/``).

Parameters are made by ``param_attr.make_parameter`` on the framework's
device (``set_device``; CUDA unless told otherwise), drawn from
``framework.random_seed.generator(device)`` in float32, then cast to the
layer's dtype. ``ParamAttr(learning_rate=)`` scales the optimizer's rate
for that parameter (``param.optimize_attr``), ``trainable=False`` makes
a parameter that requires no grad.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device
from .param_attr import ParamAttr, make_parameter

__all__ = ["Layer", "ParamAttr", "make_parameter"]

_name_counts: collections.Counter = collections.Counter()


def _unique_name(scope):
    """``scope`` numbered by how often it was asked for: "linear_0",
    "linear_1", ..."""
    n = _name_counts[scope]
    _name_counts[scope] += 1
    return f"{scope}_{n}"


class Layer(nn.Module):
    """paddle's ``nn.Layer`` on ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = (dtype_mod.convert_dtype(dtype)
                       or dtype_mod.default_dtype())
        self._full_name = _unique_name(name_scope
                                       or type(self).__name__.lower())

    # -- construction -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        return make_parameter(shape, attr, dtype or self._dtype, is_bias,
                              default_initializer, resolve_device(None))

    def create_variable(self, name=None, persistable=None, dtype=None):
        return torch.zeros((), dtype=dtype_mod.convert_dtype(dtype)
                           or self._dtype, device=resolve_device(None))

    def add_parameter(self, name, parameter):
        if parameter is None:
            self._parameters.pop(name, None)
            return None
        if not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, nn.Module):
            raise TypeError("add_sublayer expects a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """A buffer; ``persistable=False`` keeps it out of the state
        dict. A non-tensor becomes one by ``to_tensor``'s rules."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            from ..tensor import to_tensor
            tensor = to_tensor(tensor)
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=rec))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=rec))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        """Every module below this one (pre-order), and this one first
        with ``include_self``."""
        return [m for m in self.modules() if include_self or m is not self]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if include_self or m is not self:
                yield name, m

    def apply(self, fn):
        for m in self.sublayers(include_self=True):
            fn(m)
        return self

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """Parameters and persistable buffers by their structured names
        (``"fc.weight"``), as the JAX package names them."""
        if prefix is not None:          # torch's own recursion into us
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        pre = f"{structured_name_prefix}." if structured_name_prefix else ""
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=pre,
                                      keep_vars=keep_vars)
        dest = collections.OrderedDict() if destination is None \
            else destination
        self._save_to_state_dict(dest, pre, keep_vars)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (tensors or arrays) into the parameters and
        buffers in place, in their dtype and on their device. Returns
        (missing keys, unexpected keys); a shape mismatch raises."""
        own = self.state_dict(keep_vars=True)
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    continue
                tgt = own[k]
                src = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(tgt.shape)}")
                tgt.copy_(src.to(tgt.device, tgt.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype and device ---------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """Cast the floating parameters and buffers to ``dtype`` and/or
        move everything to ``device`` (a dtype given first is read as
        the dtype)."""
        if device is not None and not isinstance(device, (str,
                                                          torch.device)):
            device, dtype = None, device
        if isinstance(device, str) and device in dtype_mod._STR2DTYPE:
            device, dtype = None, device
        dt = dtype_mod.convert_dtype(dtype)
        dev = resolve_device(device) if device is not None else None
        super().to(device=dev, dtype=dt, **kwargs)
        if dt is not None:
            self._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- hooks --------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; a non-None return replaces the
        output. The handle's ``remove()`` takes it off."""
        return self.register_forward_hook(hook)

    # -- misc -----------------------------------------------------------------
    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._full_name


