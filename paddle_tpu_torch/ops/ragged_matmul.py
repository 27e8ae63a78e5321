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

Three variants, chosen before the launch by ``_variant`` from dtype,
strides and alignment: ``"tc"`` (bf16 on the tensor cores, fed by TMA;
the main path's), ``"mma_sync"`` (the first bf16 kernel, for operands TMA
cannot read) and ``"cuda_core"`` (every fp32 call). CUDA tensors launch
the kernel or raise; CPU tensors take the plain version.
``ragged_group_matmul.launches`` counts kernel launches and
``launches_by_variant`` each variant's.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ragged_group_matmul", "ragged_group_matmul_reference",
           "ragged_dot"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
_ENTRY = {"tc": "ragged_group_matmul_tc",
          "mma_sync": "ragged_group_matmul_mma",
          "cuda_core": "ragged_group_matmul_fma"}
_ROWS, _COLS = 128, 256   # the tensor-core kernel's row and column tiles
#: blocks per SM the tensor-core grid aims at, were every row tile live
_BLOCKS_PER_SM = 4


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


def _variant(x, w):
    """The variant for these operands: ``"tc"`` when x and w are bf16 and
    TMA can read them as 3-d tensor maps: 16-byte aligned bases, x's K
    contiguous and w's k or n contiguous, every other stride a multiple of
    8 elements (16 bytes) and nested (a row inside its group), N a multiple
    of 8 (the output's rows are TMA-stored), K at least 1. Other bf16
    operands take ``"mma_sync"``, and every fp32 call ``"cuda_core"`` (the
    tensor cores would round fp32 to TF32)."""
    if x.dtype != torch.bfloat16:
        return "cuda_core"
    G, C, K = x.shape
    N = w.shape[2]
    xg, xc, xk = x.stride()
    wg, wk, wn = w.stride()
    if wn == 1:                     # MN-major: rows of N inside K
        w_ok = wk % 8 == 0 and wk >= N and wg % 8 == 0 and wg >= K * wk
    elif wk == 1:                   # K-major (w^T): rows of K inside N
        w_ok = wn % 8 == 0 and wn >= K and wg % 8 == 0 and wg >= N * wn
    else:
        w_ok = False
    x_ok = (xk == 1 and xc % 8 == 0 and xc >= K and xg % 8 == 0
            and xg >= C * xc)
    if (w_ok and x_ok and K >= 1 and N % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tc"
    return "mma_sync"


def _col_runs(G, C, N, sms):
    """The tensor-core grid's blocks along N: each block walks a run of
    the column tiles of one group's 128-row tile. About ``_BLOCKS_PER_SM``
    blocks per SM were every row tile live (the host does not know the
    counts), and runs of equal length: ``runs`` is cut back to
    ``ceil(n_ct / ceil(n_ct / runs))``, so that no run is twice another
    (8 column tiles in 7 runs would make one block of two tiles the last
    wave)."""
    n_ct = -(-N // _COLS)
    row_blocks = G * -(-C // _ROWS)
    runs = max(1, min(n_ct, -(-_BLOCKS_PER_SM * sms // row_blocks)))
    return -(-n_ct // -(-n_ct // runs))


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
        x = x.contiguous()    # the kernels read x's rows with K contiguous
    cnt = counts.to(torch.int32).contiguous()      # stays on the device
    out = torch.empty((G, C, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    variant = _variant(x, w)
    runs = 1
    if variant == "tc":
        runs = _col_runs(G, C, N, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    fn = _build.load("ragged_matmul", _ENTRY[variant], _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                 G, C, K, N, x.stride(0), x.stride(1), *w.stride(),
                 _DTYPES[x.dtype], _DTYPES[out_dtype], runs,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, _ENTRY[variant])
    ragged_group_matmul.launches += 1
    ragged_group_matmul.launches_by_variant[variant] += 1
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
ragged_group_matmul.launches_by_variant = {"tc": 0, "mma_sync": 0,
                                           "cuda_core": 0}
