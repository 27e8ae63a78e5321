"""``ParamAttr`` and the parameter makers every port layer uses
(``make_parameter``, ``_param``). They sit below both ``layer_base`` and
``layer/*.py``, which import them from here.

Parameters are made on the framework's device (``set_device``; CUDA
unless told otherwise) and drawn from
``framework.random_seed.generator(device)`` in float32, then cast to the
layer's dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device
from ..framework.random_seed import generator
from .initializer import Constant, XavierUniform

__all__ = ["ParamAttr", "make_parameter"]


def _param(shape, init, device, dtype):
    """An ``nn.Parameter`` of ``shape`` filled by ``init`` in float32 from
    the device's generator, then cast to ``dtype``."""
    dev = resolve_device(device)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    init(t, generator(dev))
    return nn.Parameter(t.to(dtype_mod.convert_dtype(dtype) or torch.float32))


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None or True: the defaults; False: no parameter; a name; an
        initialiser."""
        if attr is None or attr is True:
            return ParamAttr()
        if isinstance(attr, ParamAttr) or attr is False:
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def make_parameter(shape, attr, dtype, is_bias, default_initializer, device):
    """An ``nn.Parameter`` of ``shape`` on ``device``: the initialiser is
    the attr's, else ``default_initializer``, else zeros for a bias and
    Xavier-uniform for a weight. None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer or (
        Constant(0.0) if is_bias else XavierUniform())
    if not callable(init):
        raise TypeError(f"not an initializer: {init!r}")
    p = _param(tuple(int(s) for s in shape), init, device,
               dtype_mod.convert_dtype(dtype) or dtype_mod.default_dtype())
    p.requires_grad_(bool(attr.trainable))
    p.optimize_attr = {"learning_rate": float(attr.learning_rate)}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p
