"""Attention functionals. Counterpart of
``paddle_tpu/nn/functional/attention.py``.

``sdpa_raw`` routes eligible inputs to the hand-written flash-attention
kernels through their autograd Function (``ops.flash_attention.
flash_attention_fn``: the forward kernel, and the dq and dk/dv kernels in
the backward), whether or not the inputs need a gradient, and everything
else to the plain composite, recording the choice and its reason in
``attention_path()``. Eligibility mirrors the JAX package's rule with
"tensor is on a CUDA device" in place of "backend is tpu": bf16/fp32,
``L >= 128`` and ``L % 128 == 0``, and a head dim the kernels are built
for (``HEAD_DIMS``, all of them ``<= 256`` as the JAX rule asks). Kernel
errors propagate (no silent fallback).
"""
from __future__ import annotations

import math

import torch

from ...ops.flash_attention import HEAD_DIMS, flash_attention_fn

# Which path the most recent sdpa_raw call took, and why.
_last_path = {"path": None, "reason": None}


def attention_path():
    """{"path": "flash"|"plain", "reason": ...} of the last sdpa_raw call."""
    return dict(_last_path)


def _record(path, reason):
    _last_path["path"] = path
    _last_path["reason"] = reason


def _plain_sdpa(q, k, v, causal=False, scale=None):
    """The plain composite ([B, L, H, D] paddle layout), arithmetic as
    ``paddle_tpu``'s ``_xla_sdpa``: the scale multiplies q in q's dtype,
    scores and softmax in float32, probabilities cast to q's dtype before
    the PV product. GQA maps query head h onto kv head h // group."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = torch.matmul((qh * s).float(), kh.float().transpose(-1, -2))
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(ql, kl, dtype=torch.bool,
                        device=q.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~cm, -1e30)
    w = torch.softmax(logits, dim=-1).to(qh.dtype)
    out = torch.matmul(w, vh)
    return out.transpose(1, 2)


def sdpa_raw(q, k, v, causal=False, scale=None):
    """Causal/full attention over [B, L, H, D] with flash routing."""
    eligible = (q.dtype in (torch.bfloat16, torch.float32)
                and q.shape[1] >= 128 and q.shape[1] % 128 == 0
                and q.shape[-1] in HEAD_DIMS and q.is_cuda)
    if eligible:
        _record("flash", "eligible on cuda")
        return flash_attention_fn(q, k, v, causal=causal, scale=scale)
    _record("plain", f"ineligible: dtype={q.dtype} shape={tuple(q.shape)} "
                     f"device={q.device} (kernel head dims {HEAD_DIMS})")
    return _plain_sdpa(q, k, v, causal=causal, scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """q/k/v: [batch, seq, heads, head_dim] (paddle flash-attn layout)."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not in the port yet (ROADMAP.md, port "
            "queue item 10: amp and attention dropout)")
    if attn_mask is not None:
        raise NotImplementedError(
            "an explicit attn_mask is not in this slice of the port "
            "(ROADMAP.md, port queue: long tail)")
    return sdpa_raw(query, key, value, causal=is_causal, scale=scale)
