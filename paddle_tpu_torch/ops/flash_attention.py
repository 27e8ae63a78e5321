"""Flash attention forward and backward: wrappers of
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, the TPU kernels these
replace, and the ``custom_vjp`` around them). Everything takes the paddle
layout ``[B, L, H, D]``; the kernels read q/k/v/dO through their strides
(no transpose copy). Causal masking is bottom-right aligned
(``offset = Lk - Lq``); GQA maps query head ``h`` onto kv head
``h // (Hq // Hkv)``.

- ``flash_attention(q, k, v, causal, scale) -> (out, lse)``: the forward
  kernel; ``lse`` is ``[B, Hq, Lq]`` fp32 (``MASK_VALUE`` on fully masked
  rows, whose ``out`` is 0). It has two variants, chosen before the launch
  by ``_variant`` from dtype, strides and alignment: ``"tc"`` (bf16 on the
  tensor cores, fed by TMA) and ``"cuda_core"`` (fp32, and bf16 operands
  TMA cannot read); ``flash_attention.launches_by_variant`` counts each.
- ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``: the two
  backward kernels. Both recompute ``p = exp(s - lse)`` and
  ``ds = p * (dO.V^T - delta) * scale`` from the saved ``lse`` and
  ``delta = rowsum(dO * O)``; dq sums ``ds.K`` over the key tiles, dk/dv
  sum ``ds^T.Q`` and ``p^T.dO`` over the query tiles and, for GQA, over
  the query heads of each kv head (inside the kernel, no atomics). Each
  has the same two variants, chosen by ``_bwd_variant`` from the four
  operands (``"tc"`` also needs a head dim in ``BWD_TC_HEAD_DIMS``), and
  counts them in ``launches_by_variant``.
- ``flash_attention_fn``: the differentiable entry point, a
  ``torch.autograd.Function`` that saves ``(q, k, v, out, lse)`` and runs
  the two backward kernels.

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions (``*_reference``). Each wrapper counts its launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_attention_fn", "attention_delta"]

# the TPU kernel's finite mask value: exp() of masked scores stays defined
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# head dims the kernels are instantiated for; sdpa_raw routes only these
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_TAIL = ([ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_FWD_ENTRY = {"tc": "flash_attention_fwd_tc",
              "cuda_core": "flash_attention_fwd"}
_DQ_ENTRY = {"tc": "flash_attention_bwd_dq_tc",
             "cuda_core": "flash_attention_bwd_dq"}
_DKV_ENTRY = {"tc": "flash_attention_bwd_dkv_tc",
              "cuda_core": "flash_attention_bwd_dkv"}
# head dims the backward's tensor-core kernels are built for; at D = 256
# dK and dV alone would take 256 fp32 registers a thread
BWD_TC_HEAD_DIMS = (32, 64, 128)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _BWD_TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _BWD_TAIL


def _default_scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _heads_first(x, group=1):
    """[B, L, H, D] -> fp32 [B, H * group, L, D] (kv heads repeated)."""
    x = x.transpose(1, 2)
    if group > 1:
        x = x.repeat_interleave(group, dim=1)
    return x.float()


def _mask(Lq, Lk, causal, device):
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=device)
    return mask.tril(diagonal=Lk - Lq) if causal else mask


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """The plain PyTorch version: the kernel's arithmetic in one pass over
    all keys (scores and softmax in fp32, p rounded to v's dtype before the
    PV product, fully masked rows give out = 0 and lse = MASK_VALUE, as the
    TPU kernel). q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D] -> (out [B, Lq, Hq,
    D] in q's dtype, lse [B, Hq, Lq] fp32)."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = _default_scale(scale, D)
    group = Hq // Hkv
    qh = _heads_first(q)
    kh = _heads_first(k, group)
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale     # [B, Hq, Lq, Lk]
    mask = _mask(Lq, Lk, causal, q.device)
    s = s.masked_fill(~mask, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.matmul(p.to(v.dtype).float(), vh.float()) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return out.to(q.dtype).transpose(1, 2), lse


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all be on CUDA")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes bf16 or fp32, all "
                        "the same")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}; want "
                         "[B, L, H, D] with k and v alike")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v differ in batch or "
                         "head dim")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q heads {Hq} not a multiple of "
                         f"kv heads {k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")


def _tma_ready(t):
    """A bf16 ``[B, L, H, D]`` operand TMA can read as a 4-d tensor map:
    16-byte aligned base, element strides that are multiples of 8 (16
    bytes), nested as head inside sequence inside batch."""
    B, L, H, D = t.shape
    sb, sl, sh, sd = t.stride()
    return (t.data_ptr() % 16 == 0 and sd == 1
            and all(x % 8 == 0 for x in (sb, sl, sh))
            and sh >= D and sl >= H * sh and sb >= L * sl)


def _variant(q, k, v):
    """The forward variant for these operands: ``"tc"`` (the bf16
    tensor-core kernel) when all three are bf16 and TMA-readable, else
    ``"cuda_core"`` (every fp32 call: the tensor cores would round fp32 to
    TF32)."""
    if q.dtype == torch.bfloat16 and all(_tma_ready(t) for t in (q, k, v)):
        return "tc"
    return "cuda_core"


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention forward on ``[B, L, H, D]``. Returns
    ``(out, lse)``; not differentiable (see ``flash_attention_fn``)."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    variant = _variant(q, k, v)
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = _default_scale(scale, D)
    out = torch.empty((B, Lq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_fwd", _FWD_ENTRY[variant], _ARGTYPES)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, Lq, Lk, Hq, Hkv, D, *strides,
                 1 if causal else 0, scale, _DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, _FWD_ENTRY[variant])
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def attention_delta(out, dout):
    """``delta = rowsum(dO * O)`` in fp32, ``[B, Hq, Lq]`` (the JAX
    package computes it in XLA beside the kernels, as here in torch)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, dout, lse, delta, causal, scale):
    """The plain recompute both backward kernels share (the TPU kernels'
    ``_recompute_p_ds``): fp32 ``p = exp(s - lse)`` (0 where masked) and
    ``ds = p * (dO.V^T - delta) * scale``, ``[B, Hq, Lq, Lk]``, with the
    kv heads repeated over their query heads."""
    Lq, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Lk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    s = torch.matmul(_heads_first(q), _heads_first(k, group).transpose(
        -1, -2)) * _default_scale(scale, D)
    mask = _mask(Lq, Lk, causal, q.device)
    # where(), not a product: masked entries may hold exp(+huge) = inf
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(_heads_first(dout), _heads_first(v, group).transpose(
        -1, -2))
    ds = p * (dp - delta[..., None]) * _default_scale(scale, D)
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                     causal=False, scale=None):
    """The dq kernel's plain version: ``dq = ds.K`` with ds rounded to k's
    dtype before the product (as the TPU kernel), fp32 sums, dq in q's
    dtype ``[B, Lq, Hq, D]``."""
    group = q.shape[2] // k.shape[2]
    _, ds = _p_ds(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), _heads_first(k, group))
    return dq.to(q.dtype).transpose(1, 2)


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                      causal=False, scale=None):
    """The dk/dv kernel's plain version: ``dk = ds^T.Q`` and
    ``dv = p^T.dO`` (ds and p rounded to the operands' dtype before the
    products), summed over each kv head's query heads in fp32; ``(dk, dv)``
    in k's and v's dtype, ``[B, Lk, Hkv, D]``."""
    B, Lk, Hkv, D = k.shape
    group = q.shape[2] // Hkv
    p, ds = _p_ds(q, k, v, dout, lse, delta, causal, scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      _heads_first(q))
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      _heads_first(dout))
    dk = dk.reshape(B, Hkv, group, Lk, D).sum(2)
    dv = dv.reshape(B, Hkv, group, Lk, D).sum(2)
    return dk.to(k.dtype).transpose(1, 2), dv.to(v.dtype).transpose(1, 2)


def _bwd_variant(q, k, v, dout):
    """The backward variant for these operands (both kernels take the
    same): ``"tc"`` (the bf16 tensor-core kernels) when all four are bf16
    and TMA-readable and the head dim is in ``BWD_TC_HEAD_DIMS``, else
    ``"cuda_core"`` (every fp32 call: the tensor cores would round fp32 to
    TF32)."""
    if (q.shape[-1] in BWD_TC_HEAD_DIMS
            and all(t.dtype == torch.bfloat16 and _tma_ready(t)
                    for t in (q, k, v, dout))):
        return "tc"
    return "cuda_core"


def _check_bwd(q, k, v, dout, lse, delta):
    _check(q, k, v)
    B, Lq, Hq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"flash_attention backward: dO {tuple(dout.shape)} "
                         f"{dout.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if dout.stride(3) != 1:
        raise ValueError("flash_attention backward: dO's head dim must be "
                         "contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, Hq, Lq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous fp32 [B, Hq, Lq] = {(B, Hq, Lq)} "
                             f"on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _bwd_args(q, k, v, dout, causal, scale):
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, dout) for s in t.stride()[:3]]
    return ([B, Lq, Lk, Hq, Hkv, D] + strides
            + [1 if causal else 0, _default_scale(scale, D),
               _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream])


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           scale=None):
    """dq of flash attention (``[B, Lq, Hq, D]`` in q's dtype) from the
    forward's ``lse`` and ``delta = attention_delta(out, dO)``."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                                causal, scale)
    _check_bwd(q, k, v, dout, lse, delta)
    variant = _bwd_variant(q, k, v, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.load("flash_attention_bwd", _DQ_ENTRY[variant],
                     _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 *_bwd_args(q, k, v, dout, causal, scale))
    _build.check(err, _DQ_ENTRY[variant])
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_variant[variant] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            scale=None):
    """(dk, dv) of flash attention (``[B, Lk, Hkv, D]`` in k's dtype),
    summed over the query heads of each kv head."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                 causal, scale)
    _check_bwd(q, k, v, dout, lse, delta)
    variant = _bwd_variant(q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = _build.load("flash_attention_bwd", _DKV_ENTRY[variant],
                     _DKV_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), *_bwd_args(q, k, v, dout, causal, scale))
    _build.check(err, _DKV_ENTRY[variant])
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_variant[variant] += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, dout, causal=False,
                             scale=None):
    """(dq, dk, dv) through the two backward kernels (their plain
    versions on the CPU). A dO whose head dim is not contiguous (an
    expanded gradient, say) is copied to a contiguous one first."""
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     scale)
    return dq, dk, dv


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal=False, scale=None):
    """The plain backward: ``delta``, then both kernels' plain versions."""
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                          causal, scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The port's ``custom_vjp``: the forward kernel saves ``(q, k, v,
    out, lse)``; the backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fn(q, k, v, causal=False, scale=None):
    """Differentiable flash attention on ``[B, L, H, D]``; returns out."""
    return _FlashAttention.apply(q, k, v, causal, scale)


#: kernel launches since the count was last reset (CPU calls not counted)
flash_attention.launches = 0
flash_attention.launches_by_variant = {"tc": 0, "cuda_core": 0}
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_variant = {"tc": 0, "cuda_core": 0}
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_variant = {"tc": 0, "cuda_core": 0}
