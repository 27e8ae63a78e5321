"""int8 x int8 -> int32 matmul with a per-row x per-column rescale: wrapper
of ``csrc/int8_matmul.cu``.

Counterpart of ``paddle_tpu/ops/pallas/int8_matmul.py``:

- ``int8_matmul_rescale(xq, x_scale, wq, w_scale, *, out_dtype)``: the
  kernel. ``xq [M, K]`` int8, ``x_scale [M, 1]`` fp32, ``wq [K, N]`` int8,
  ``w_scale [1, N]`` fp32 -> ``[M, N]`` in ``out_dtype`` (bf16 or fp32 on
  the card): ``(xq @ wq).float() * x_scale * w_scale``, the int32 sums
  exact, the two products in that order. ``wq`` is taken as it lies,
  row-major (``[K, N]`` contiguous) or K-major (the ``[K, N]`` view of a
  contiguous ``[N, K]``, as ``Int8Linear.qweight`` stores it), and
  copied only where the kernels cannot read it (below).
  ``block_m``/``block_n`` and ``interpret`` are accepted for the JAX
  signature and ignored (the kernels' tiles are fixed in the source).
- ``int8_matmul_rescale_reference``: its plain version. The int32 sums
  come from an int32 matmul on the CPU and a float64 one on CUDA (CUDA
  has no integer matmul; float64 is exact, since K * 127^2 < 2^53); then
  the same products in the same order, so kernel and plain version agree
  bit for bit.
- ``_quant_rows``: per-row symmetric int8 quantization of activations, in
  plain PyTorch (it lies outside the TPU kernel too).
- ``int8_linear(x, wq, w_scale, out_dtype)``: ``x @ dequant(wq)`` computed
  as the int8 matmul with x quantized per row on the fly, a
  ``torch.autograd.Function``. Its backward is the straight-through
  ``dx = ct.f32 @ (wq.f32 * w_scale.f32)^T`` cast to x's dtype; the int8
  weight and its scale are inference buffers and get no gradient.

Two variants, chosen before the launch by ``_variant`` from wq's layout,
K and alignment: ``"tc"`` (the tensor cores through ``wgmma`` s8 fed by
TMA, the main path's: Hopper's int8 ``wgmma`` reads K-major operands
only) and ``"mma_sync"`` (the first kernel, for a row-major wq and for
operands TMA cannot read: K not a multiple of 16, or a base off 16
bytes). ``"mma_sync"`` reads wq row-major only, so a K-major wq that TMA
cannot read is copied to row-major (``wq.contiguous()``) before that
launch. ``Int8Linear`` under its default routing never gives it one: it
takes the kernels only where in_features % 128 == 0, on its own aligned
buffer. CUDA tensors launch the chosen kernel or raise; CPU tensors take
the plain version. ``int8_matmul_rescale.launches`` counts kernel
launches and ``launches_by_variant`` each variant's.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul_rescale", "int8_matmul_rescale_reference",
           "int8_linear"]

_OUT = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY = {"tc": "int8_matmul_rescale_tc",
          "mma_sync": "int8_matmul_rescale_mma"}


def int8_matmul_rescale_reference(xq, x_scale, wq, w_scale,
                                  out_dtype=torch.bfloat16):
    """The plain version: exact int32 sums, then ``acc.float() * x_scale
    * w_scale`` cast to ``out_dtype``."""
    if xq.is_cuda:
        acc = xq.double() @ wq.double()        # exact integers
    else:
        acc = xq.int() @ wq.int()
    return (acc.float() * x_scale.float() * w_scale.float()).to(out_dtype)


def _check(xq, x_scale, wq, w_scale, out_dtype):
    ts = (xq, x_scale, wq, w_scale)
    if not all(t.is_cuda for t in ts):
        raise ValueError("int8_matmul_rescale: xq, x_scale, wq, w_scale "
                         "must all be on CUDA")
    if len({t.device for t in ts}) != 1:
        raise ValueError("int8_matmul_rescale: operands on different "
                         "devices")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul_rescale: xq {xq.dtype}, wq "
                        f"{wq.dtype}; the kernel takes int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul_rescale: scales {x_scale.dtype}/"
                        f"{w_scale.dtype}; the kernel takes float32")
    if out_dtype not in _OUT:
        raise TypeError(f"int8_matmul_rescale: out_dtype {out_dtype}; want "
                        "bf16 or fp32")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul_rescale: shapes xq {tuple(xq.shape)}"
                         f" wq {tuple(wq.shape)}; want [M, K] and [K, N]")
    M, N = xq.shape[0], wq.shape[1]
    if tuple(x_scale.shape) != (M, 1) or tuple(w_scale.shape) != (1, N):
        raise ValueError(f"int8_matmul_rescale: scales {tuple(x_scale.shape)}"
                         f" and {tuple(w_scale.shape)}; want ({M}, 1) and "
                         f"(1, {N})")
    if not (all(t.is_contiguous() for t in (xq, x_scale, w_scale))
            and (wq.is_contiguous() or _k_major(wq))):
        raise ValueError("int8_matmul_rescale: the kernels take contiguous "
                         "xq and scales, and a wq that is contiguous or the "
                         "transpose of a contiguous tensor")


def _k_major(wq):
    """wq ``[K, N]`` lies K-major: its transpose ``[N, K]`` is
    contiguous."""
    return wq.t().is_contiguous()


def _variant(xq, wq):
    """The variant for these operands: ``"tc"`` when wq is K-major and TMA
    can read both operands (K a multiple of 16, so every row starts on 16
    bytes; both bases 16-byte aligned); ``"mma_sync"`` otherwise (a
    row-major wq, which the int8 ``wgmma`` cannot read, or what TMA
    cannot)."""
    K = xq.shape[1]
    if (_k_major(wq) and K >= 16 and K % 16 == 0
            and xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0):
        return "tc"
    return "mma_sync"


def int8_matmul_rescale(xq, x_scale, wq, w_scale, *,
                        out_dtype=torch.bfloat16, block_m: int = 256,
                        block_n: int = 256, interpret: bool = False):
    """``(xq [M, K] int8 @ wq [K, N] int8).float() * x_scale [M, 1] *
    w_scale [1, N]`` -> ``[M, N]`` in ``out_dtype``."""
    if not xq.is_cuda:
        return int8_matmul_rescale_reference(xq, x_scale, wq, w_scale,
                                             out_dtype)
    _check(xq, x_scale, wq, w_scale, out_dtype)
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    variant = _variant(xq, wq)
    if variant == "mma_sync":
        wq = wq.contiguous()        # the first kernel reads wq row-major
    fn = _build.load("int8_matmul", _ENTRY[variant], _ARGTYPES)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), M, N, K,
                 _OUT[out_dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, _ENTRY[variant])
    int8_matmul_rescale.launches += 1
    int8_matmul_rescale.launches_by_variant[variant] += 1
    return out


def div(t, c):
    """``t / c`` for a Python number ``c``, rounded as an IEEE division on
    every device. PyTorch's CUDA kernels turn a division by a Python
    scalar into a multiply by its reciprocal, which can differ in the last
    bit from the CPU's result and from the JAX package's ``amax / 127``;
    a 0-d tensor divisor keeps the true division."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _quant_rows(x):
    """Per-row symmetric int8 quantization of activations: ``(q int8,
    scale [..., 1] fp32)`` with ``scale = max(max|x| / 127, 1e-10)``."""
    xf = x.float()
    s = torch.clamp_min(div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                        1e-10)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, w_scale, out_dtype):
        ctx.save_for_backward(wq, w_scale)
        ctx.x_dtype = x.dtype
        orig = x.shape
        xq, xs = _quant_rows(x.reshape(-1, orig[-1]))
        # wq [K, N] is passed as it lies, row-major or K-major (the kernel
        # raises on any other strides); Int8Linear's K-major qweight runs
        # on the tensor cores with no copy
        y = int8_matmul_rescale(xq, xs, wq,
                                w_scale.float().reshape(1, -1).contiguous(),
                                out_dtype=out_dtype)
        return y.reshape(*orig[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, ct):
        wq, w_scale = ctx.saved_tensors
        w = wq.float() * w_scale.float()
        dx = (ct.float() @ w.t()).to(ctx.x_dtype)
        return dx, None, None, None


def int8_linear(x, wq, w_scale, out_dtype=torch.bfloat16, interpret=False):
    """``y = x @ dequant(wq)`` as an int8 matmul: x quantized per row on
    the fly, int32 sums, both scales in the epilogue. Differentiable in x
    (straight-through through the dequantized weight)."""
    return _Int8Linear.apply(x, wq, w_scale, out_dtype)


#: kernel launches since the count was last reset (CPU calls not counted)
int8_matmul_rescale.launches = 0
int8_matmul_rescale.launches_by_variant = {"tc": 0, "mma_sync": 0}
