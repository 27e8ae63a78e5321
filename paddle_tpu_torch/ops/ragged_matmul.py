"""Ragged grouped matmul for MoE expert dispatch: wrapper of
``csrc/ragged_matmul.cu``.

Counterpart of ``paddle_tpu/ops/pallas/ragged_matmul.py``:

- ``ragged_group_matmul(x, w, counts)``: the kernel. ``x [G, C, K]``,
  ``w [G, K, N]``, ``counts [G]`` int -> ``[G, C, N]`` with
  ``out[g, r] = x[g, r] @ w[g]`` for ``r < counts[g]`` and exactly 0
  past it, accumulated in fp32 and stored in ``out_dtype`` (x's dtype by
  default). Row tiles wholly past ``counts[g]`` skip their product.
  ``counts`` stays on the device: the kernel reads it, the host never
  does. ``block_m``/``block_n`` are accepted for the JAX signature and do
  not select the kernel's tiles (those are fixed in the source).
- ``ragged_group_matmul_reference``: its plain version, the masked einsum.
- ``ragged_dot(x, w, counts)``: the differentiable form (the JAX
  ``custom_vjp``), a ``torch.autograd.Function``. The backward computes
  dx with the kernel on ``(dy, w^T, counts)`` (``w^T`` is a strided view;
  the kernel reads w through its strides) and dw as the dense per-group
  contraction of the masked ``x`` with ``dy`` (``torch.bmm``), which the
  JAX package also leaves to XLA.

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version. ``ragged_group_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ragged_group_matmul", "ragged_group_matmul_reference",
           "ragged_dot"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def _valid(counts, C, device):
    """``[G, C]`` bool: row ``r`` of group ``g`` is live (``r <
    counts[g]``)."""
    return (torch.arange(C, device=device)[None, :]
            < counts.to(device).long()[:, None])


def ragged_group_matmul_reference(x, w, counts, out_dtype=None):
    """The plain version: the dense per-group product in fp32 with the
    rows past each count set to 0."""
    y = torch.einsum("gck,gkn->gcn", x.float(), w.float())
    y = torch.where(_valid(counts, x.shape[1], x.device)[..., None], y, 0.0)
    return y.to(out_dtype or x.dtype)


def _check(x, w, counts, out_dtype):
    if not (x.is_cuda and w.is_cuda and counts.is_cuda):
        raise ValueError("ragged_group_matmul: x, w, counts must all be on "
                         "CUDA")
    if not (x.device == w.device == counts.device):
        raise ValueError("ragged_group_matmul: operands on different "
                         "devices")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"ragged_group_matmul: dtypes {x.dtype}/{w.dtype}; "
                        "the kernel takes bf16 or fp32, both the same")
    if out_dtype not in _DTYPES:
        raise TypeError(f"ragged_group_matmul: out_dtype {out_dtype}; want "
                        "bf16 or fp32")
    if counts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ragged_group_matmul: counts are {counts.dtype}, "
                        "want int32 or int64")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"ragged_group_matmul: shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}; want [G, C, K] and [G, K, N]")
    if counts.shape != (x.shape[0],):
        raise ValueError(f"ragged_group_matmul: counts "
                         f"{tuple(counts.shape)}, want [{x.shape[0]}]")


def ragged_group_matmul(x, w, counts, block_m=None, block_n=None,
                        out_dtype=None):
    """``x [G, C, K] @ w [G, K, N]`` per group with rows ``>= counts[g]``
    zero -> ``[G, C, N]`` in ``out_dtype`` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return ragged_group_matmul_reference(x, w, counts, out_dtype)
    _check(x, w, counts, out_dtype)
    G, C, K = x.shape
    N = w.shape[2]
    if x.stride(2) != 1:
        x = x.contiguous()    # the kernel reads x's rows with K contiguous
    cnt = counts.to(torch.int32).contiguous()      # stays on the device
    out = torch.empty((G, C, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.load("ragged_matmul", "ragged_group_matmul", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                 G, C, K, N, x.stride(0), x.stride(1), *w.stride(),
                 _DTYPES[x.dtype], _DTYPES[out_dtype],
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ragged_group_matmul")
    ragged_group_matmul.launches += 1
    return out


class _RaggedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return ragged_group_matmul(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # rows past counts come out 0, as the forward's do
            dx = ragged_group_matmul(dy, w.transpose(1, 2), counts,
                                     out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            xm = x * _valid(counts, x.shape[1], x.device)[..., None].to(
                x.dtype)
            # fp32 operands: exact fp32; bf16: cuBLAS sums in fp32 and
            # rounds once to w's dtype, as the JAX einsum's fp32 result
            # cast to w's dtype
            dw = torch.bmm(xm.transpose(1, 2), dy.to(x.dtype)).to(w.dtype)
        return dx, dw, None


def ragged_dot(x, w, counts):
    """Differentiable ragged grouped matmul (the MoE expert-FFN form):
    ``y[g, c] = x[g, c] @ w[g]`` for ``c < counts[g]``, else 0."""
    return _RaggedDot.apply(x, w, counts)


#: kernel launches since the count was last reset (CPU calls not counted)
ragged_group_matmul.launches = 0
