"""Fused LM-head cross-entropy: wrapper of ``csrc/fused_ce.cu``.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py`` (single-device part):

- ``fused_ce_stats(hidden, w, labels, vocab_offset=0) -> (m, s, lab)``:
  the kernel. ONE pass over vocabulary tiles computes each row's online
  log-sum-exp triple of ``hidden @ w`` (``nll = log(s) + m - lab``); the
  logits exist only as a register tile. ``fused_ce_stats_reference`` is
  its plain version (the same online log-sum-exp over vocabulary chunks).
  Two variants, chosen before the launch by ``_variant`` from dtype,
  strides and alignment: ``"tc"`` (bf16 on the tensor cores, fed by TMA)
  and ``"cuda_core"`` (fp32, and bf16 operands TMA cannot read, such as a
  vocabulary of 301 or 50257 columns); ``fused_ce_stats.launches_by_variant``
  counts each.
- ``fused_ce_loss(hidden, w, labels, chunk_size)``: the mean CE as a
  ``torch.autograd.Function`` (the JAX ``custom_vjp``). Its backward
  re-walks the vocabulary in ``chunk_size`` columns from the saved
  stats (``_nll_grads_chunked``), so the gradient never holds ``[N, V]``
  either. Those chunk products are plain ``torch.matmul`` in fp32, as the
  JAX package left them to XLA with fp32 results.
- ``fused_ce_reference``: the dense log-softmax oracle.

- ``fused_ce_loss(..., group=tp)``: the counterpart of the JAX
  ``sharded_vocab_ce``, for a head split over a tensor-parallel group:
  rank r's kernel launch covers its ``[H, V/tp]`` shard, columns
  ``[r V/tp, (r+1) V/tp)`` (``vocab_offset``), the (max, exp-sum, label
  logit) triples are merged over the group, and the backward runs the
  chunked grads on the local shard and sums dhidden over the group.

hidden ``[N, H]``, w ``[H, V]`` (the paddle ``Linear`` layout
``[in, out]``), labels ``[N]`` integers. CUDA tensors launch the kernel
or raise; CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_ce_stats", "fused_ce_stats_reference", "fused_ce_loss",
           "fused_ce_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_ROWS, _COLS = 32, 128    # the CUDA-core kernel's row and column tiles
_ENTRY = {"tc": "fused_ce_stats_tc", "cuda_core": "fused_ce_stats"}
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def fused_ce_stats_reference(hidden, w, labels, vocab_offset=0, chunk=8192):
    """The kernel's plain version: the online log-sum-exp of the fp32
    logits ``hidden @ w``, walking the vocabulary ``chunk`` columns at a
    time so that ``[N, V]`` never exists: the row max, the exp-sum below
    it and the label's logit (0 when the label is not one of this ``w``'s
    columns)."""
    N = hidden.shape[0]
    h32 = hidden.float()
    labels = labels.long()
    m = torch.full((N,), MASK_VALUE, dtype=torch.float32,
                   device=hidden.device)
    s = torch.zeros((N,), dtype=torch.float32, device=hidden.device)
    lab = torch.zeros_like(s)
    for off in range(0, w.shape[1], chunk):
        logits = torch.matmul(h32, w[:, off:off + chunk].float())
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        col = vocab_offset + off + torch.arange(logits.shape[1],
                                                device=w.device)
        hit = col[None, :] == labels[:, None]
        lab = lab + torch.where(hit, logits, 0.0).sum(dim=1)
    return m, s, lab


def _check(hidden, w, labels):
    if not (hidden.is_cuda and w.is_cuda and labels.is_cuda):
        raise ValueError("fused_ce_stats: hidden, w, labels must all be on "
                         "CUDA")
    if not (hidden.device == w.device == labels.device):
        raise ValueError("fused_ce_stats: operands on different devices")
    if hidden.dtype not in _DTYPES or w.dtype != hidden.dtype:
        raise TypeError(f"fused_ce_stats: dtypes {hidden.dtype}/{w.dtype}; "
                        "the kernel takes bf16 or fp32, both the same")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fused_ce_stats: labels are {labels.dtype}, want "
                        "int32 or int64")
    if hidden.dim() != 2 or w.dim() != 2 or hidden.shape[1] != w.shape[0]:
        raise ValueError(f"fused_ce_stats: shapes hidden "
                         f"{tuple(hidden.shape)} w {tuple(w.shape)}; want "
                         "[N, H] and [H, V]")
    if labels.shape != (hidden.shape[0],):
        raise ValueError(f"fused_ce_stats: labels {tuple(labels.shape)}, "
                         f"want [{hidden.shape[0]}]")
    if w.shape[1] == 0 or hidden.shape[1] == 0:
        raise ValueError("fused_ce_stats: empty hidden or vocabulary dim")
    for name, t in (("hidden", hidden), ("w", w)):
        if t.stride(1) != 1:
            raise ValueError(f"fused_ce_stats: {name}'s last dim must be "
                             "contiguous")


def _variant(hidden, w):
    """The variant for these operands: ``"tc"`` (the bf16 tensor-core
    kernel) when both are bf16 and TMA can read them as 2-d tensor maps
    (16-byte aligned base, a row stride that is a multiple of 8 elements
    and at least the row), else ``"cuda_core"`` (every fp32 call: the
    tensor cores would round fp32 to TF32)."""
    if hidden.dtype == torch.bfloat16 and all(
            t.data_ptr() % 16 == 0 and t.stride(1) == 1
            and t.stride(0) % 8 == 0 and t.stride(0) >= t.shape[1]
            for t in (hidden, w)):
        return "tc"
    return "cuda_core"


def _splits(variant, N, V, device):
    """Vocabulary splits. CUDA cores: enough (row tile, split) blocks for
    ~4 per SM. Tensor cores (one block per SM): 4 vocabulary tiles per
    block, so the grid is many waves deep and its last wave short."""
    tiles = -(-V // _COLS)
    if variant == "tc":
        return -(-tiles // 4)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-N // _ROWS)
    return max(1, min(tiles, -(-4 * sms // row_tiles)))


def fused_ce_stats(hidden, w, labels, vocab_offset=0):
    """Online-logsumexp stats of ``hidden @ w`` against ``labels``:
    ``(m, s, lab)``, each fp32 ``[N]``."""
    if not hidden.is_cuda:
        return fused_ce_stats_reference(hidden, w, labels, vocab_offset)
    _check(hidden, w, labels)
    N, H = hidden.shape
    V = w.shape[1]
    lbl = labels.to(torch.int64).contiguous()
    variant = _variant(hidden, w)
    splits = _splits(variant, N, V, hidden.device)
    part = torch.empty((splits, 3, N), dtype=torch.float32,
                       device=hidden.device)
    out = torch.empty((3, N), dtype=torch.float32, device=hidden.device)
    fn = _build.load("fused_ce", _ENTRY[variant], _ARGTYPES)
    with torch.cuda.device(hidden.device):
        err = fn(hidden.data_ptr(), w.data_ptr(), lbl.data_ptr(),
                 part.data_ptr(), splits, out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), N, H, V,
                 hidden.stride(0), w.stride(0), int(vocab_offset),
                 _DTYPES[hidden.dtype],
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, _ENTRY[variant])
    fused_ce_stats.launches += 1
    fused_ce_stats.launches_by_variant[variant] += 1
    fused_ce_stats.last_columns = (int(vocab_offset), int(vocab_offset) + V)
    return out[0], out[1], out[2]


def _nll_grads_chunked(hidden, w, labels, m, s, g, chunk, vocab_offset=0):
    """Backward over vocabulary chunks: ``dlogits = (softmax - onehot) *
    g`` rebuilt per chunk from the saved stats, never ``[N, V]``; ``w``'s
    column j is vocabulary entry ``vocab_offset + j``. The products are
    fp32 (bf16 operands are exact in fp32), as the JAX package's
    ``preferred_element_type=float32`` dots."""
    N, H = hidden.shape
    V = w.shape[1]
    h32 = hidden.float()
    lse = m + torch.log(s)
    labels = labels.long()
    dh = torch.zeros((N, H), dtype=torch.float32, device=hidden.device)
    dw = torch.empty((H, V), dtype=w.dtype, device=w.device)
    for off in range(0, V, chunk):
        w_c = w[:, off:off + chunk].float()
        logits = torch.matmul(h32, w_c)                       # [N, chunk]
        p = torch.exp(logits - lse[:, None])
        col = vocab_offset + off + torch.arange(w_c.shape[1],
                                                device=w.device)
        d = (p - (col[None, :] == labels[:, None]).float()) * g[:, None]
        dh += torch.matmul(d, w_c.t())
        dw[:, off:off + chunk] = torch.matmul(h32.t(), d).to(w.dtype)
    return dh.to(hidden.dtype), dw


class _FusedCELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, labels, chunk_size, group):
        off = 0 if group is None else group.rank * w.shape[1]
        m, s, lab = fused_ce_stats(hidden, w, labels, vocab_offset=off)
        if group is not None:               # merge the shards' triples
            from ..distributed.collective import ReduceOp, all_reduce
            gm = all_reduce(m.clone(), ReduceOp.MAX, group)
            s = all_reduce(s * torch.exp(m - gm), group=group)
            lab = all_reduce(lab, group=group)
            m = gm
        ctx.save_for_backward(hidden, w, labels, m, s)
        ctx.chunk_size, ctx.group, ctx.off = chunk_size, group, off
        return (torch.log(s) + m - lab).mean()

    @staticmethod
    def backward(ctx, ct):
        hidden, w, labels, m, s = ctx.saved_tensors
        N = hidden.shape[0]
        g = (ct.float() / N).expand(N)
        if ctx.group is None:
            dh, dw = _nll_grads_chunked(hidden, w, labels, m, s, g,
                                        ctx.chunk_size)
            return dh, dw, None, None, None
        from ..distributed.collective import all_reduce
        # this shard's part of dhidden, summed over the group in fp32
        dh, dw = _nll_grads_chunked(hidden.float(), w, labels, m, s, g,
                                    ctx.chunk_size, ctx.off)
        dh = all_reduce(dh, group=ctx.group)
        return dh.to(hidden.dtype), dw, None, None, None


def fused_ce_loss(hidden, w, labels, chunk_size=1024, group=None):
    """Mean cross-entropy of ``hidden @ w`` against ``labels`` without
    the ``[N, V]`` logits (scalar fp32); differentiable in hidden and w,
    the backward walking ``chunk_size`` vocabulary columns at a time.
    With a tensor-parallel ``group`` of several ranks, ``w`` is rank r's
    ``[H, V/tp]`` column shard (columns ``[r V/tp, (r+1) V/tp)``),
    ``hidden`` and the global ``labels`` are the same on every rank, and
    every rank gets the full mean; dhidden is summed over the group, dw
    stays local."""
    if torch.float16 in (hidden.dtype, w.dtype):
        # amp.decorate(dtype="float16") beside the fused head: the JAX
        # package's chunk scan takes any float dtype, the kernel does not
        raise NotImplementedError(
            "fused_ce_loss: fp16 operands; the fused-CE kernel takes bf16 "
            "or fp32 (ROADMAP.md, port queue item 9: long tail)")
    if group is not None and group.nranks == 1:
        group = None
    return _FusedCELoss.apply(hidden, w, labels, int(chunk_size), group)


def fused_ce_reference(hidden, w, labels):
    """Dense log-softmax oracle (materializes ``[N, V]``; tests only)."""
    logits = torch.matmul(hidden.float(), w.float())
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


#: kernel launches since the count was last reset (CPU calls not counted)
fused_ce_stats.launches = 0
fused_ce_stats.launches_by_variant = {"tc": 0, "cuda_core": 0}
#: the vocabulary columns ``(first, end)`` the last launch covered
fused_ce_stats.last_columns = None
