"""Convolution. Counterpart of ``paddle_tpu/nn/functional/conv.py``
(``conv1d``, ``conv2d``, ``conv3d`` and the three transposed ones).

Channels-first activations and the paddle weight layouts, ``[out, in /
groups, *k]`` and for a transposed convolution ``[in, out / groups,
*k]``, which are torch's own, so the weight is used as it is. The JAX
package lowers every convolution to ``lax.conv_general_dilated``,
outside any Pallas kernel; here it is cuDNN's convolution
(``aten.convolution``). The padding forms are the JAX package's: an int,
one per spatial dim, per-side pairs flattened (``[h_lo, h_hi, w_lo, w_hi]``), nested pairs (also the
full-rank NCHW form), or "SAME" / "VALID" with XLA's split of an odd
total (the extra row at the high end). Unequal sides pad the input first.
The bias is added after the convolution, in its output dtype, as in JAX.

A transposed convolution is JAX's ``_conv_transpose``: the convolution
of the stride-dilated input with the flipped kernel padded by ``eff_k -
1 - pad`` below and ``eff_k - 1 - pad + output_padding`` above (``eff_k``
the dilated kernel's extent), which is torch's transposed convolution
where the pads are equal and ``output_padding`` is below the stride or
the dilation; otherwise the full transposed convolution is cut (or
zero-extended) to those pads.

Every convolution is an amp cast site (``amp.maybe_cast_compute``), as
the JAX package's ``_conv`` is.

Channels-last (``NLC``, ``NHWC``, ``NDHWC``): x is ``[N, *spatial, C]``
and the weight keeps its channels-first layout, as in the JAX package.
The convolution runs on x's channels-first view, which for a contiguous
channels-last tensor is torch's ``channels_last`` memory format, so
cuDNN takes its NHWC kernels and nothing is copied; the output comes
back as the NHWC view of the result (contiguous when cuDNN returns
``channels_last``).

fp32 means fp32: on CUDA, cuDNN rounds fp32 convolution operands to TF32
by default (``torch.backends.cudnn.allow_tf32``), so on fp32 CUDA operands
the convolution and its two backward convolutions run with TF32 off
(``_ConvFp32``), as the port's fp32 matmuls do
(``torch.backends.cuda.matmul.allow_tf32`` defaults to False). bf16 and
fp16 operands, and CPU tensors, take ``aten.convolution`` as it is.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import maybe_cast_compute

__all__ = ["conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose"]


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


class _ConvFp32(torch.autograd.Function):
    """An fp32 CUDA convolution (plain or transposed) whose forward and
    backward convolutions all run with cuDNN's TF32 off (autograd runs the
    backward outside the forward's context, so it is pinned there too)."""

    @staticmethod
    def forward(ctx, x, weight, conf):
        ctx.save_for_backward(x, weight)
        ctx.conf = conf
        with _no_tf32():
            return torch.ops.aten.convolution(x, weight, None, *conf)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, weight, None, *ctx.conf, mask)
        return dx, dw, None


def _convolution(x, weight, stride, pads, dilation, transposed, opad,
                 groups):
    """``aten.convolution`` of channels-first ``x``; on fp32 CUDA operands
    through ``_ConvFp32``."""
    conf = (list(stride), list(pads), list(dilation), transposed,
            list(opad), groups)
    if x.dtype == torch.float32 and x.device.type == "cuda":
        return _ConvFp32.apply(x, weight, conf)
    return torch.ops.aten.convolution(x, weight, None, *conf)


_CHANNEL_LAST = ("NLC", "NWC", "NHWC", "NDHWC")


def _to_first(x):
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


def _add_bias(out, bias, channel_last):
    if bias is None:
        return out
    shape = [1] * out.dim()
    shape[-1 if channel_last else 1] = -1
    return out + bias.to(out.dtype).reshape(shape)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pads = _padding(padding, n, channel_last)
    x, weight = maybe_cast_compute(x, weight)
    if channel_last:
        x = _to_first(x)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if any(lo != hi for lo, hi in pads):
        x = TF.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        pads = [(0, 0)] * n
    out = _convolution(x, weight, stride, [lo for lo, _ in pads], dilation,
                       False, (0,) * n, groups)
    if channel_last:
        out = _to_last(out)
    return _add_bias(out, bias, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of ``x [N, C, L]`` (``[N, L, C]`` with "NLC")."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 "NWC" if data_format == "NLC" else "NCW")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x [N, C, H, W]`` (``[N, H, W, C]`` with
    ``data_format="NHWC"``) with ``weight [O, C / groups, kh, kw]``, plus
    ``bias [O]``."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    groups, dilation, n, data_format):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pads = _padding(padding, n, channel_last)
    if isinstance(pads, str):
        raise ValueError(f"conv{n}d_transpose: padding must be numbers, got "
                         f"{padding!r}")
    opad = _norm_tuple(output_padding, n)
    x, weight = maybe_cast_compute(x, weight)
    if channel_last:
        x = _to_first(x)
    native = all(lo == hi and o < max(s, d) for (lo, hi), o, s, d
                 in zip(pads, opad, stride, dilation))
    if native:
        out = _convolution(x, weight, stride, [lo for lo, _ in pads],
                           dilation, True, opad, groups)
    else:
        out = _convolution(x, weight, stride, (0,) * n, dilation, True,
                           (0,) * n, groups)
        for d, ((lo, hi), o) in enumerate(zip(pads, opad)):
            axis, cut = 2 + d, hi - o
            if cut < 0:
                widths = [0, 0] * (out.dim() - 1 - axis) + [0, -cut]
                out = TF.pad(out, widths)
                cut = 0
            out = out.narrow(axis, lo, out.shape[axis] - lo - cut)
    if channel_last:
        out = _to_last(out)
    return _add_bias(out, bias, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 1,
                           "NWC" if data_format == "NLC" else "NCW")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """The transposed 2-D convolution of ``x [N, C_in, H, W]`` with
    ``weight [C_in, C_out / groups, kh, kw]``. ``output_size`` is accepted
    and not read, as in the JAX package."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 3, data_format)
