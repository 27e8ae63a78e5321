"""Convolution. Counterpart of ``paddle_tpu/nn/functional/conv.py``
(``conv2d``).

NCHW activations and the paddle weight layout ``[out, in / groups, kh,
kw]``, which is torch's own, so the weight is used as it is. The JAX
package lowers the convolution to ``lax.conv_general_dilated``, outside
any Pallas kernel; here it is ``torch.nn.functional.conv2d``. The
padding forms are the JAX package's: an int, one per spatial dim, per-side
pairs flattened (``[h_lo, h_hi, w_lo, w_hi]``), nested pairs (also the
full-rank NCHW form), or "SAME" / "VALID" with XLA's split of an odd
total (the extra row at the high end). Unequal sides pad the input first.
The bias is added after the convolution, in its output dtype, as in JAX.

``conv2d`` is an amp cast site (``amp.maybe_cast_compute``), as the JAX
package's ``_conv`` is.

Channels-last (``data_format="NHWC"``): x is ``[N, H, W, C]`` and the
weight keeps the ``[O, I / groups, kh, kw]`` layout, as in the JAX
package. The convolution runs on x's channels-first view, which for a
contiguous NHWC tensor is torch's ``channels_last`` memory format, so
cuDNN takes its NHWC kernels and nothing is copied; the output comes
back as the NHWC view of the result (contiguous when cuDNN returns
``channels_last``).

fp32 means fp32: on CUDA, cuDNN rounds fp32 convolution operands to TF32
by default (``torch.backends.cudnn.allow_tf32``), so on fp32 CUDA operands
the convolution and its two backward convolutions run with TF32 off
(``_Conv2dFp32``), as the port's fp32 matmuls do
(``torch.backends.cuda.matmul.allow_tf32`` defaults to False). bf16 and
fp16 operands, and CPU tensors, take ``torch.nn.functional.conv2d`` as
it is.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import maybe_cast_compute

__all__ = ["conv2d"]


def _norm_tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 2 * n:            # paddle allows per-side pairs flattened
            return tuple(v)
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _padding(padding, n, channel_last=False):
    """Per spatial dim (lo, hi) pairs, or "SAME" / "VALID"."""
    if isinstance(padding, str):
        p = padding.upper()
        if p in ("SAME", "VALID"):
            return p
        raise ValueError(padding)
    if isinstance(padding, (list, tuple)) and padding \
            and isinstance(padding[0], (list, tuple)):
        spatial = padding
        if len(padding) == n + 2:       # full rank, batch and channel too
            spatial = padding[1:-1] if channel_last else padding[2:]
        return [tuple(int(v) for v in p) for p in spatial]
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(p, p) for p in _norm_tuple(padding, n)]


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's SAME padding: the output is ceil(in / stride) long; the
    lower side gets the floor of half the total."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size,
                    0)
        pads.append((total // 2, total - total // 2))
    return pads


@contextlib.contextmanager
def _no_tf32():
    """cuDNN with TF32 off inside (the setting is put back after)."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


class _Conv2dFp32(torch.autograd.Function):
    """An fp32 CUDA convolution whose forward and backward convolutions
    all run with cuDNN's TF32 off (autograd runs the backward outside
    the forward's context, so it is pinned there too)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups)
        with _no_tf32():
            return TF.conv2d(x, weight, None, stride, padding, dilation,
                             groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        conf = ctx.conf
        dx = dw = None
        with _no_tf32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, weight, g, *conf)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, *conf)
        return dx, dw, None, None, None, None


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x [N, C, H, W]`` (``[N, H, W, C]`` with
    ``data_format="NHWC"``) with ``weight [O, C / groups, kh, kw]``, plus
    ``bias [O]``."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    channel_last = data_format == "NHWC"
    stride = _norm_tuple(stride, 2)
    dilation = _norm_tuple(dilation, 2)
    pads = _padding(padding, 2, channel_last)
    x, weight = maybe_cast_compute(x, weight)
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    if pads == "VALID":
        pads = [(0, 0), (0, 0)]
    elif pads == "SAME":
        pads = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if any(lo != hi for lo, hi in pads):
        (hlo, hhi), (wlo, whi) = pads
        x = TF.pad(x, (wlo, whi, hlo, hhi))
        pads = [(0, 0), (0, 0)]
    pads = tuple(lo for lo, _ in pads)
    if x.dtype == torch.float32 and x.device.type == "cuda":
        out = _Conv2dFp32.apply(x, weight, stride, pads, dilation, groups)
    else:
        out = TF.conv2d(x, weight, None, stride, pads, dilation, groups)
    if channel_last:
        out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(
            (1, 1, 1, -1) if channel_last else (1, -1, 1, 1))
    return out
