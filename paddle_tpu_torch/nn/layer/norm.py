"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``RMSNorm``, ``LayerNorm``, ``BatchNorm`` and ``BatchNorm1D/2D/3D``,
``GroupNorm``, ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm``).

RMSNorm's arithmetic (``F.rms_norm``, also this module's ``rms_norm``)
is exactly ``paddle_tpu.text.generation._rms``: mean of squares in
float32, ``rsqrt``, cast back to the input dtype, THEN multiply by the
weight (in bf16 the product rounds after the cast, as on
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

from .. import functional as F
from ..initializer import Constant
from ..layer_base import Layer
from ..functional.norm import rms_norm
from ..param_attr import make_parameter
from ...framework.device import resolve_device
from ...framework.dtype import convert_dtype

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm", "SyncBatchNorm",
           "rms_norm"]


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.epsilon = float(epsilon)
        self.weight = make_parameter((int(hidden_size),), weight_attr, dtype,
                                     False, Constant(1.0), device)

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


def _scale_shift(c, weight_attr, bias_attr, device, dtype):
    """Ones and zeros of shape ``c`` (None where the attr is False)."""
    return (make_parameter(c, weight_attr, dtype, False, Constant(1.0),
                           device),
            make_parameter(c, bias_attr, dtype, True, None, device))


class LayerNorm(Layer):
    """Normalises over the trailing ``normalized_shape`` axes; weight
    ones and bias zeros (``weight_attr``/``bias_attr=False`` drop them)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight, self.bias = _scale_shift(
            self.normalized_shape, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class _BatchNormBase(Layer):
    """``F.batch_norm`` with its statistics kept in the buffers ``_mean``
    and ``_variance``; training mode follows ``nn.Module.training``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._num_features = int(num_features)
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        c = (self._num_features,)
        self.weight, self.bias = _scale_shift(c, weight_attr, bias_attr,
                                              device, dtype)
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


class GroupNorm(Layer):
    """``F.group_norm`` over ``num_groups`` groups of channels; weight ones,
    bias zeros."""

    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _scale_shift((num_channels,), weight_attr,
                                              bias_attr, device, dtype)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """``F.instance_norm``; weight ones, bias zeros, no running buffers
    (the JAX package keeps none)."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._epsilon = epsilon
        self.weight, self.bias = _scale_shift((num_features,), weight_attr,
                                              bias_attr, device, dtype)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)
