"""Weight-only int8 quantization. Counterpart of
``paddle_tpu/nn/quant/__init__.py``.

Weights are stored int8 with per-output-channel fp32 scales in the paddle
``[in, out]`` layout (``Int8Linear`` buffers ``qweight`` ``[in, out]``
int8, ``scale`` ``[1, out]`` fp32, ``act_scale`` ``[]`` fp32), so
``state_dict``s carry across from the JAX package unchanged. ``qweight``
lies K-major: it is the ``[in, out]`` view of ``[out, in]`` storage (its
``.t()`` is contiguous), the one layout Hopper's int8 tensor cores read.
Every path that fills it (``from_linear``, ``load_state_dict``,
``framework.io.load_numpy_state_dict``, PTQ and QAT convert) copies into
it in place, and ``Module.to`` preserves strides, so it stays K-major.

``Int8Linear.forward`` routes as the JAX layer does, by
``PADDLE_TPU_INT8_MXU``: ``"1"`` always takes ``ops.int8_matmul.
int8_linear`` (x quantized per row, the hand-written int8 kernel on CUDA,
its plain version on the CPU); ``"auto"`` (the default) takes it for a
CUDA input when ``in_features`` is a multiple of 128 and at most 16384;
otherwise (and for ``"0"``) the dequantized product ``x @ (q * s)`` with
q and s cast to x's dtype before the multiply. A calibrated ``act_scale``
(> 0) first quantize-dequantizes x to its int8 grid. The JAX package
reads ``act_scale`` on the host every call; the port reads it only when
the buffer changed (a new tensor, or an in-place write, seen by its
version counter), so a steady-state forward makes no host sync. A
buffer with no version counter (made under ``torch.inference_mode``) is
never read: the QDQ is then selected on the device. The outputs are the
same either way.

``stochastic_round`` and ``quantize_int8_stochastic`` keep the JAX
signatures (2-D input, integer ``seed``) and gating (``ValueError``
outside ``MOSAIC_SR_TARGETS``, ``NotImplementedError`` for targets other
than bf16); they run the hand-written kernels of
``ops/stochastic_round.py`` on CUDA and their plain versions on the CPU.
Their random words are the port's own (threefry2x32, documented there),
not the TPU's.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.dtype import convert_dtype
from ...ops import stochastic_round as _sr
from ...ops.int8_matmul import div, int8_linear
from ..layer.common import Linear

__all__ = ["quantize_int8", "dequantize_int8", "Int8Linear",
           "quantize_model", "quantize_int8_stochastic",
           "stochastic_round", "MOSAIC_SR_TARGETS",
           "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
           "FakeQuantChannelWiseAbsMax", "QuantizedLinear",
           "QuantizedConv2D", "ImperativeQuantAware",
           "PostTrainingQuantization", "fake_quant_dequant",
           "adaround_weight", "run_adaround"]


def _quant_raw(w, axis=-1):
    """Symmetric int8 along ``axis``: scale ``max(max|w| / 127, 1e-10)``
    in fp32; ``w / scale`` in fp32 (also for a bf16 w), rounded half to
    even and clipped to +-127."""
    scale = torch.clamp_min(
        div(w.float().abs().amax(dim=axis, keepdim=True), 127.0), 1e-10)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(w, axis: int = -1):
    """Per-channel symmetric int8: returns ``(int8 tensor, fp32 scale)``,
    the scale reduced along ``axis`` (kept as size 1)."""
    return _quant_raw(torch.as_tensor(w).detach(), axis)


def dequantize_int8(q, scale, dtype="float32"):
    dt = convert_dtype(dtype)
    return q.to(dt) * scale.to(dt)


# float targets the TPU's stochastic-rounding lowering accepts; the JAX
# package gates its public function to these names, and so does the port
MOSAIC_SR_TARGETS = ("bfloat16", "float8_e5m2", "float8_e4m3fn",
                     "float8_e4m3b11fnuz")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return getattr(dtype, "name", None) or str(dtype)


def _check_2d(x, what):
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be 2-D [rows, cols], got "
                         f"{tuple(x.shape)}")


def stochastic_round(x, dtype=torch.bfloat16, seed: int = 0,
                     interpret: bool = False):
    """fp32 -> low-precision float, stochastically rounded: each value
    becomes one of its two neighbours on the target grid, the one away
    from zero with probability equal to the dropped fraction. The target
    is gated to :data:`MOSAIC_SR_TARGETS`; only bf16 is implemented.
    ``interpret`` is accepted for the JAX signature and ignored."""
    name = _dtype_name(dtype)
    if name not in MOSAIC_SR_TARGETS:
        raise ValueError(
            f"stochastic_round target {name!r} unsupported; the TPU kernel "
            f"accepts {MOSAIC_SR_TARGETS} (integer targets: use "
            "quantize_int8_stochastic, which rounds in fp32)")
    if name != "bfloat16":
        raise NotImplementedError(
            "only the bf16 target is implemented on this backend")
    _check_2d(x, "stochastic_round")
    return _sr.stochastic_round_bf16(x.float().contiguous(), seed)


def quantize_int8_stochastic(w, seed: int = 0, interpret: bool = False):
    """Int8 quantization with stochastic rounding on the device.

    w: ``[rows, cols]``; per-tensor scale. Returns ``(int8, scale [1,
    1])`` with ``E[q * scale] == w`` inside the range. ``interpret`` is
    accepted for the JAX signature and ignored.
    """
    _check_2d(w, "quantize_int8_stochastic")
    return _sr.quantize_int8_stochastic(w.float().contiguous(), seed)


#: host reads of an ``act_scale`` (tests count them: a steady-state
#: forward makes none)
act_scale_reads = 0


def _read_act_scale(t) -> float:
    global act_scale_reads
    act_scale_reads += 1
    return float(t)


class Int8Linear(nn.Module):
    """Linear with an int8 weight and a per-output-channel scale
    (weight-only).

    ``act_scale`` (optional, set by PTQ calibration): when > 0, the input
    is quantize-dequantized to the calibrated int8 grid before the matmul,
    so the deployed model reproduces the activation-quantization error,
    not just the weight error."""

    def __init__(self, in_features, out_features, bias=True, *,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        # [in, out] with K-major storage: the view of [out, in]
        self.register_buffer("qweight", torch.zeros(
            (self.out_features, self.in_features), dtype=torch.int8,
            device=dev).t())
        self.register_buffer("scale", torch.ones(
            (1, self.out_features), dtype=torch.float32, device=dev))
        # activation QDQ grid step; 0 = disabled. A buffer so PTQ
        # calibration survives state_dict save/load.
        self.register_buffer("act_scale", torch.zeros(
            (), dtype=torch.float32, device=dev))
        self.bias = (nn.Parameter(torch.zeros(
            self.out_features, dtype=torch.float32, device=dev))
            if bias else None)
        # (act_scale tensor, its version, act_scale > 0) of the last read
        self._act_seen = None

    @classmethod
    def from_linear(cls, linear: Linear, scale=None) -> "Int8Linear":
        w = linear.weight.detach()
        m = cls(linear.in_features, linear.out_features,
                bias=linear.bias is not None, device=w.device)
        # an explicit scale (or one pinned by AdaRound) must be honoured:
        # recomputing abs-max from an adarounded weight can shift the grid
        # (a channel max rounded down), destroying the learned rounding
        if scale is None:
            scale = getattr(linear, "_adaround_scale", None)
        if scale is not None:
            s = torch.as_tensor(scale, dtype=torch.float32,
                                device=w.device).reshape(1, -1)
            q = torch.clamp(torch.round(w.float() / s), -127,
                            127).to(torch.int8)
        else:
            q, s = quantize_int8(w, axis=0)            # per out-channel
        with torch.no_grad():
            m.qweight.copy_(q)
            m.scale.copy_(s)
        if linear.bias is not None:
            m.bias = nn.Parameter(linear.bias.detach().clone())
        return m

    def forward(self, x):
        mode = os.environ.get("PADDLE_TPU_INT8_MXU", "auto")
        use_kernel = (mode == "1"
                      or (mode == "auto" and x.is_cuda
                          and self.in_features % 128 == 0
                          and self.in_features <= 16384))
        x = self._act_qdq(x)
        if use_kernel:
            y = int8_linear(x, self.qweight, self.scale, x.dtype)
        else:
            y = x @ (self.qweight.to(x.dtype) * self.scale.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def _act_qdq(self, x):
        """x quantize-dequantized to the ``act_scale`` grid where it is
        > 0, else x; the host reads ``act_scale`` only when the buffer
        changed since the last read."""
        from .qat import fake_quant_dequant
        t = self.act_scale
        if t.is_inference():
            # no version counter to tell a write: select on the device
            return torch.where(t > 0, fake_quant_dequant(x, t), x)
        seen = self._act_seen
        if seen is None or seen[0] is not t or seen[1] != t._version:
            seen = self._act_seen = (t, t._version, _read_act_scale(t) > 0)
        return fake_quant_dequant(x, t) if seen[2] else x

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def quantize_model(model: nn.Module, include=None) -> nn.Module:
    """Swap every ``nn.Linear`` (optionally only those whose dotted name
    contains one of the ``include`` substrings) for an ``Int8Linear``
    holding the quantized weights. In place; returns the model."""
    for name, sub in list(model.named_modules()):
        for child_name, child in list(sub._modules.items()):
            if isinstance(child, Linear):
                full = f"{name}.{child_name}" if name else child_name
                if include and not any(k in full for k in include):
                    continue
                sub._modules[child_name] = Int8Linear.from_linear(child)
    if isinstance(model, Linear):
        raise TypeError("pass a container Layer, not a bare Linear")
    return model


from .qat import (FakeQuantAbsMax, FakeQuantChannelWiseAbsMax,  # noqa: E402
                  FakeQuantMovingAverageAbsMax, ImperativeQuantAware,
                  PostTrainingQuantization, QuantizedConv2D,
                  QuantizedLinear, fake_quant_dequant)
from .adaround import adaround_weight, run_adaround  # noqa: E402
