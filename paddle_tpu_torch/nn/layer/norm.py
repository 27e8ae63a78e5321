"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``RMSNorm``, ``LayerNorm``, ``BatchNorm`` and ``BatchNorm1D/2D/3D``).

RMSNorm's arithmetic is exactly ``paddle_tpu.text.generation._rms``: mean
of squares in float32, ``rsqrt``, cast back to the input dtype, THEN
multiply by the weight (in bf16 the product rounds after the cast, as on
the JAX side). ``LayerNorm`` runs ``F.layer_norm`` with the same order.

The batch norms hold the JAX package's names: ``weight`` (ones),
``bias`` (zeros) and the buffers ``_mean`` (zeros) and ``_variance``
(ones), with no ``num_batches_tracked``, so their ``state_dict`` keys are
JAX's. ``SyncBatchNorm`` is not in the port: the train step refuses a
batch norm at a data degree above 1 (``fleet.placement``), since each
rank would see only its shard of the batch.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from ...framework.device import resolve_device
from ...framework.dtype import convert_dtype
from .common import _no_attr, _param

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm", "SyncBatchNorm", "rms_norm"]


def rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = _param((int(hidden_size),), Constant(1.0), device,
                             dtype)

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """Normalises over the trailing ``normalized_shape`` axes; weight
    ones and bias zeros (``weight_attr``/``bias_attr=False`` drop them)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype="float32"):
        super().__init__()
        _no_attr("LayerNorm", weight_attr=weight_attr, bias_attr=bias_attr)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = (None if weight_attr is False else _param(
            self.normalized_shape, Constant(1.0), device, dtype))
        self.bias = (None if bias_attr is False else _param(
            self.normalized_shape, Constant(0.0), device, dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class _BatchNormBase(nn.Module):
    """``F.batch_norm`` with its statistics kept in the buffers ``_mean``
    and ``_variance``; training mode follows ``nn.Module.training``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        _no_attr(type(self).__name__, weight_attr=weight_attr,
                 bias_attr=bias_attr)
        self._num_features = int(num_features)
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        c = (self._num_features,)
        self.weight = (None if weight_attr is False else
                       _param(c, Constant(1.0), device, dtype))
        self.bias = (None if bias_attr is False else
                     _param(c, Constant(0.0), device, dtype))
        dev = resolve_device(device)
        dt = convert_dtype(dtype) or torch.float32
        self.register_buffer("_mean", torch.zeros(c, dtype=dt, device=dev))
        self.register_buffer("_variance", torch.ones(c, dtype=dt,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}, "
                f"data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm: not in the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm is not in the port: batch statistics over the "
            "data-parallel group are queued (ROADMAP.md, port queue item "
            "9). At a data degree of 1 BatchNorm is the same layer")

    @classmethod
    def convert_sync_batchnorm(cls, layer, axis_name=None):
        cls()
