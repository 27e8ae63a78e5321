"""Quantization-aware training and post-training quantization.
Counterpart of ``paddle_tpu/nn/quant/qat.py``.

Fake quantization is a quantize-dequantize with a straight-through
estimator: the clip carries the gradient (zero outside the representable
range), the rounding is a detached residual. Observers are modules whose
buffers (``scale``, ``initialized``) update in training forward and freeze
in eval. The scale an observer computes from its input stays in the
autograd graph, as in the JAX package's compiled step (its observers do
not stop the gradient through the scale): where the clip bound cuts
values, their gradient reaches the input's abs-max through the scale.

``ImperativeQuantAware.convert`` and ``PostTrainingQuantization`` emit the
weight-only ``Int8Linear``. Conv2D waits for the port's Conv2D (ROADMAP.md,
port queue item 9): ``QuantizedConv2D`` and every branch that would touch
a convolution raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.int8_matmul import div
from .. import functional as F
from ..layer.common import Linear

__all__ = ["FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
           "FakeQuantChannelWiseAbsMax", "QuantizedLinear",
           "QuantizedConv2D", "ImperativeQuantAware",
           "PostTrainingQuantization", "fake_quant_dequant",
           "calibration_pass"]

_CONV_TODO = ("Conv2D quantization waits for the port's Conv2D (ROADMAP.md, "
              "port queue item 9: long tail)")


def _is_conv(m) -> bool:
    return isinstance(m, nn.Conv2d)


def _qdq_ste(x, scale, bits):
    """Quantize-dequantize with STE: the clip carries the gradient (to x
    inside the range, to the bound outside it), the round is a detached
    residual."""
    bound = float(2 ** (bits - 1) - 1)
    s = torch.clamp_min(scale.float(), 1e-10)
    limit = bound * s
    y = torch.clamp(x.float(), -limit, limit)
    qdq = torch.round(y / s) * s
    out = y + (qdq - y).detach()
    return out.to(x.dtype)


def fake_quant_dequant(x, scale, bits=8):
    """Functional QDQ with STE."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _qdq_ste(x, scale, bits)


class FakeQuantAbsMax(nn.Module):
    """Per-tensor abs-max scale recomputed every call (weights)."""

    def __init__(self, bits=8):
        super().__init__()
        self.bits = bits

    def scale_of(self, x):
        return div(x.float().abs().amax(), 2 ** (self.bits - 1) - 1)

    def forward(self, x):
        return _qdq_ste(x, self.scale_of(x), self.bits)


class FakeQuantChannelWiseAbsMax(nn.Module):
    """Per-channel abs-max (weights; the channel axis is ``quant_axis``,
    -1 for a ``Linear``'s ``[in, out]`` weight)."""

    def __init__(self, bits=8, quant_axis=-1):
        super().__init__()
        self.bits = bits
        self.quant_axis = quant_axis

    def scale_of(self, x):
        axes = tuple(a for a in range(x.dim())
                     if a != self.quant_axis % x.dim())
        return div(x.float().abs().amax(dim=axes, keepdim=True),
                   2 ** (self.bits - 1) - 1)

    def forward(self, x):
        return _qdq_ste(x, self.scale_of(x), self.bits)


class FakeQuantMovingAverageAbsMax(nn.Module):
    """EMA abs-max observer (activations): the ``scale`` buffer updates in
    training forward and freezes in eval."""

    def __init__(self, bits=8, momentum=0.9):
        super().__init__()
        self.bits = bits
        self.momentum = momentum
        self.register_buffer("scale", torch.zeros((), dtype=torch.float32))
        self.register_buffer("initialized",
                             torch.zeros((), dtype=torch.float32))

    def forward(self, x):
        if self.training:
            mom = self.momentum
            amax = div(x.float().abs().amax(), 2 ** (self.bits - 1) - 1)
            prev = self.scale.to(x.device)
            scale = torch.where(self.initialized.to(x.device) > 0,
                                mom * prev + (1 - mom) * amax, amax)
            with torch.no_grad():
                self.scale.copy_(scale)
                self.initialized.fill_(1.0)
        else:
            scale = self.scale
        return _qdq_ste(x, scale, self.bits)


_WEIGHT_OBSERVERS = {
    "abs_max": FakeQuantAbsMax,
    "channel_wise_abs_max": FakeQuantChannelWiseAbsMax,
}
_ACT_OBSERVERS = {
    "moving_average_abs_max": FakeQuantMovingAverageAbsMax,
    "abs_max": FakeQuantAbsMax,
}


class QuantizedLinear(nn.Module):
    """Linear with weight and input fake-quant."""

    def __init__(self, layer: Linear, weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        super().__init__()
        self.inner = layer
        wq = _WEIGHT_OBSERVERS[weight_quantize_type]
        self.weight_fake_quant = (
            wq(weight_bits, quant_axis=-1)
            if wq is FakeQuantChannelWiseAbsMax else wq(weight_bits))
        self.act_fake_quant = _ACT_OBSERVERS[activation_quantize_type](
            activation_bits)
        dev = layer.weight.device
        self.act_fake_quant.to(dev)

    def forward(self, x):
        xq = self.act_fake_quant(x)
        wq = self.weight_fake_quant(self.inner.weight)
        return F.linear(xq, wq, self.inner.bias)


class QuantizedConv2D(nn.Module):
    """Conv2D with weight and input fake-quant: not in the port yet."""

    def __init__(self, layer=None, *args, **kwargs):
        raise NotImplementedError(_CONV_TODO)


class ImperativeQuantAware:
    """Rewrites a model in place for QAT (``quantize``) and converts it
    back to an inference model with real int8 weights (``convert``)."""

    def __init__(self, quantizable_layer_type=("Linear", "Conv2D"),
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_bits=8, activation_bits=8):
        self._types = set(quantizable_layer_type)
        self._kw = dict(weight_bits=weight_bits,
                        activation_bits=activation_bits,
                        weight_quantize_type=weight_quantize_type,
                        activation_quantize_type=activation_quantize_type)

    def quantize(self, model: nn.Module) -> nn.Module:
        for _, sub in list(model.named_modules()):
            for cname, child in list(sub._modules.items()):
                if type(child) is Linear and "Linear" in self._types:
                    sub._modules[cname] = QuantizedLinear(child, **self._kw)
                elif _is_conv(child) and "Conv2D" in self._types:
                    raise NotImplementedError(_CONV_TODO)
        return model

    @staticmethod
    def convert(model: nn.Module) -> nn.Module:
        """QAT model -> inference model: each ``QuantizedLinear`` becomes
        an ``Int8Linear`` with the trained weight snapped to its per-
        channel grid (the observer's activation scale is not carried, as
        in the JAX package)."""
        from . import Int8Linear
        for _, sub in list(model.named_modules()):
            for cname, child in list(sub._modules.items()):
                if isinstance(child, QuantizedLinear):
                    sub._modules[cname] = Int8Linear.from_linear(child.inner)
        return model


def calibration_pass(model, data_loader, hook_factories, max_batches=None):
    """Shared calibration scaffolding (PTQ observers and AdaRound's input
    capture): register the given forward-pre-hooks (``[(module, hook)]``),
    feed up to ``max_batches`` batches through the eval-mode model without
    gradients, remove the hooks."""
    hooks = [layer.register_forward_pre_hook(hook)
             for layer, hook in hook_factories]
    model.eval()
    try:
        with torch.no_grad():
            for i, batch in enumerate(data_loader):
                if max_batches is not None and i >= max_batches:
                    break
                args = batch if isinstance(batch, (tuple, list)) \
                    else (batch,)
                model(*[torch.as_tensor(a) for a in args])
    finally:
        for h in hooks:
            h.remove()


class PostTrainingQuantization:
    """Calibration-based PTQ (algo ``abs_max`` or ``avg``): feed
    calibration batches through the float model while per-layer observers
    record the input ranges, then emit the int8-weight inference model
    (``round_type="adaround"`` learns the weight rounding first)."""

    def __init__(self, model: nn.Module, algo="abs_max", weight_bits=8,
                 activation_bits=8, round_type="round"):
        if algo not in ("abs_max", "avg"):
            raise ValueError(f"unsupported algo {algo!r}")
        if round_type not in ("round", "adaround"):
            raise ValueError(f"unsupported round_type {round_type!r}")
        self.model = model
        self.algo = algo
        self.round_type = round_type
        self._bits = activation_bits
        self._weight_bits = weight_bits
        self._act_ranges = {}

    def _observe(self, name):
        def hook(layer, inputs):
            x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            amax = float(torch.as_tensor(x).float().abs().max())
            if self.algo == "abs_max":
                self._act_ranges[name] = max(
                    self._act_ranges.get(name, 0.0), amax)
            else:  # avg
                prev = self._act_ranges.get(name)
                self._act_ranges[name] = (amax if prev is None
                                          else 0.5 * (prev + amax))
        return hook

    def quantize(self, data_loader, max_batches=None):
        """Run calibration, then convert; returns the inference model."""
        if any(_is_conv(m) for m in self.model.modules()):
            raise NotImplementedError(_CONV_TODO)
        if self.round_type == "adaround":
            # learn the weight rounding first, baked onto the int8 grid so
            # the conversion below reproduces it on the same scale; the
            # loader may be one-shot, and both passes must see the same
            # batches
            from .adaround import run_adaround
            cap = max_batches if max_batches is not None else 8
            batches = []
            for i, b in enumerate(data_loader):
                if i >= cap:
                    break
                batches.append(b)
            run_adaround(batches, self.model, max_batches=cap)
            data_loader = batches
            max_batches = cap
        targets = [(n, m) for n, m in self.model.named_modules()
                   if n and type(m) is Linear]
        calibration_pass(
            self.model, data_loader,
            [(layer, self._observe(name)) for name, layer in targets],
            max_batches=max_batches)

        from . import Int8Linear
        for pname, sub in list(self.model.named_modules()):
            for cname, child in list(sub._modules.items()):
                full = f"{pname}.{cname}" if pname else cname
                if type(child) is Linear:
                    q = Int8Linear.from_linear(child)
                    rng_ = self._act_ranges.get(full)
                    if rng_ is not None:
                        # range -> grid step of the layer's input QDQ
                        q.act_scale.fill_(rng_ / (2 ** (self._bits - 1) - 1))
                    sub._modules[cname] = q
        return self.model

    @property
    def activation_ranges(self):
        return dict(self._act_ranges)
