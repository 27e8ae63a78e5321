"""Channels-last (NHWC) layout planning for conv models. Counterpart of
``paddle_tpu/framework/layout.py`` (``to_channels_last``,
``ChannelsLast``, ``fold_conv_bn``).

* ``to_channels_last(model)`` rewrites every ``Conv2D``, batch norm and
  ``_Pool`` layer of the model to its channels-last ``data_format`` and
  returns a :class:`ChannelsLast` wrapper whose forward moves the input
  NCHW -> NHWC once at the entry and a 4-D output back once at the exit.
  Between the two every layer reads and writes NHWC. On the card an NHWC
  tensor is the NHWC view of a ``torch.channels_last`` tensor, so cuDNN
  runs its NHWC convolution and batch-norm kernels with no transposes in
  between (the entry makes the one copy).
* ``fold_conv_bn(model)`` folds each eval-mode batch norm into the conv
  just before it (inference only) and replaces it by ``Identity``.

The wrapped region must be layout-safe: every spatial op a converted
layer or elementwise, any flatten after the spatial dims reach 1 x 1.
Models that are opt in through the class attribute ``_channels_last_safe``
(``ResNet``); any other model needs ``force=True``. The JAX package's
``count_hlo_transposes`` lints XLA's HLO and has no counterpart without
a compiler IR (port queue item 8).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

__all__ = ["ChannelsLast", "LayoutPlan", "fold_conv_bn", "to_channels_last"]


class LayoutPlan:
    """Which layers a channels-last conversion rewrote, and where the
    layout boundary sits."""

    def __init__(self, converted, boundary="NCHW->NHWC@entry"):
        self.converted = tuple(converted)
        self.boundary = boundary

    def __repr__(self):
        return (f"LayoutPlan({len(self.converted)} layers channels-last, "
                f"boundary={self.boundary!r})")


_CHANNEL_LAST = {"NCHW": "NHWC", "NCW": "NWC", "NCL": "NLC",
                 "NCDHW": "NDHWC"}


def _convert_layer(layer):
    """Flip one layer to its channels-last ``data_format``; True if it
    was rewritten."""
    from ..nn.layer.conv import Conv2D
    from ..nn.layer.norm import _BatchNormBase
    from ..nn.layer.pooling import _Pool

    if isinstance(layer, (Conv2D, _BatchNormBase)):
        new = _CHANNEL_LAST.get(layer._data_format)
        if new is not None:
            layer._data_format = new
            return True
        return False
    if isinstance(layer, _Pool):
        new = _CHANNEL_LAST.get(layer._kw.get("data_format"))
        if new is not None:
            layer._kw["data_format"] = new
            return True
        # the adaptive max pools take no data_format: they stay
        # channels-first (none in a model marked safe)
    return False


def to_channels_last(model, force=False):
    """Rewrite ``model``'s conv, batch-norm and pool layers to channels-
    last and wrap it: the wrapper takes NCHW, returns NCHW for a 4-D
    output and passes a 2-D one (logits) through. ``train()``/``eval()``
    and ``state_dict`` follow the wrapped model (keys gain a ``model.``
    prefix)."""
    if isinstance(model, ChannelsLast):
        return model
    if not getattr(model, "_channels_last_safe", False) and not force:
        raise ValueError(
            f"{type(model).__name__} is not marked channels-last-safe "
            "(needs every spatial op layout-aware and flatten only after "
            "1x1 pooling); pass force=True to convert anyway")
    converted = []
    for name, sub in model.named_modules():
        if _convert_layer(sub):
            converted.append(name or type(sub).__name__)
    return ChannelsLast(model, LayoutPlan(converted))


class ChannelsLast(nn.Module):
    """Layout-region boundary: NCHW in, NHWC inside, NCHW (or 2-D) out."""

    def __init__(self, model, plan):
        super().__init__()
        self.model = model
        self.plan = plan

    def forward(self, x):
        if x.dim() == 4:
            # the one copy: NHWC storage, i.e. channels_last memory format
            x = x.permute(0, 2, 3, 1).contiguous()
        out = self.model(x)
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            out = out.permute(0, 3, 1, 2)
        return out


def fold_conv_bn(model):
    """Fold eval-mode batch norm into the conv before it (in place).

    For every ``Conv2D`` followed, in registration order within the same
    parent (the dataflow order everywhere in the vision models), by a
    batch norm over its ``out_channels``:

        scale = gamma / sqrt(running_var + eps)
        W'    = W * scale            (per out-channel)
        b'    = (b - running_mean) * scale + beta

    in float64 on the host, cast back to the weight's dtype, and the
    batch norm is replaced by ``Identity``. The running statistics are
    used, so this is for eval and export only (a warning when the batch
    norm is in training mode). Returns the folded batch norms' names.
    """
    from ..nn.layer.common import Identity
    from ..nn.layer.conv import Conv2D
    from ..nn.layer.norm import _BatchNormBase

    target = model.model if isinstance(model, ChannelsLast) else model
    folded = []
    for pname, parent in target.named_modules():
        prev = None
        for name, sub in list(parent._modules.items()):
            if (isinstance(sub, _BatchNormBase) and isinstance(prev, Conv2D)
                    and sub._num_features == prev._out_channels):
                if sub.training:
                    warnings.warn(
                        "fold_conv_bn on a training-mode BN: folding uses "
                        "running stats; call model.eval() first",
                        stacklevel=2)
                _fold_pair(prev, sub)
                parent._modules[name] = Identity()
                folded.append(f"{pname}.{name}" if pname else name)
                prev = None
                continue
            prev = sub
    return folded


def _host64(t):
    return t.detach().to("cpu", torch.float64).numpy()


def _fold_pair(conv, bn):
    w = conv.weight
    c = bn._num_features
    gamma = _host64(bn.weight) if bn.weight is not None else np.ones((c,))
    beta = _host64(bn.bias) if bn.bias is not None else np.zeros((c,))
    scale = gamma / np.sqrt(_host64(bn._variance) + bn._epsilon)
    w64 = _host64(w) * scale.reshape((-1,) + (1,) * (w.dim() - 1))
    b = _host64(conv.bias) if conv.bias is not None else np.zeros((c,))
    new_b = (b - _host64(bn._mean)) * scale + beta
    with torch.no_grad():
        w.copy_(torch.from_numpy(w64))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(new_b))
        else:
            conv.bias = nn.Parameter(torch.from_numpy(new_b).to(
                device=w.device, dtype=w.dtype))
