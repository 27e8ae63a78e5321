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

``scaled_dot_product_attention`` routes as the JAX package does: a call
with no ``attn_mask`` and no training dropout goes to ``sdpa_raw``; every
other call goes to the plain composite (the JAX package's XLA
composite), which applies the mask and the dropout, and
``attention_path()`` records why. No kernel sees a mask or dropout, in
either package. The dropout keep mask is drawn from
``framework.random_seed``'s generator for q's device, as ``F.dropout``'s
is, so ``seed(n)`` repeats it (the numbers are not the JAX package's).
"""
from __future__ import annotations

import math

import torch

from ...framework.random_seed import generator
from ...ops.flash_attention import HEAD_DIMS, flash_attention_fn

# Which path the most recent sdpa_raw call took, and why.
_last_path = {"path": None, "reason": None}


def attention_path():
    """{"path": "flash"|"plain", "reason": ...} of the last sdpa_raw call."""
    return dict(_last_path)


def _record(path, reason):
    _last_path["path"] = path
    _last_path["reason"] = reason


def _plain_sdpa(q, k, v, causal=False, scale=None, mask=None, dropout_p=0.0,
                _keep=None):
    """The plain composite ([B, L, H, D] paddle layout), arithmetic as
    ``paddle_tpu``'s ``_xla_sdpa``: the scale multiplies q in q's dtype,
    scores and softmax in float32, probabilities cast to q's dtype before
    the PV product. GQA maps query head h onto kv head h // group.

    ``mask`` broadcasts against the ``[B, H, Lq, Lk]`` scores: a bool mask
    keeps the True entries (the rest get -1e30), a float mask is added in
    fp32. With ``dropout_p > 0`` each probability is kept with chance
    ``1 - p`` and scaled by ``1 / (1 - p)`` after the cast to q's dtype;
    the keep mask is drawn from ``framework.random_seed.generator``, or
    is ``_keep`` (a bool tensor of the scores' shape) when given."""
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
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.to(logits.dtype)
    w = torch.softmax(logits, dim=-1).to(qh.dtype)
    if dropout_p > 0.0:
        if _keep is None:
            _keep = torch.rand(w.shape, generator=generator(q.device),
                               device=q.device) >= dropout_p
        w = torch.where(_keep, w / (1.0 - dropout_p), 0.0).to(w.dtype)
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
    """q/k/v: [batch, seq, heads, head_dim] (paddle flash-attn layout);
    ``attn_mask`` broadcasts against the ``[batch, heads, Lq, Lk]``
    scores (bool: keep where True; float: added)."""
    use_dropout = dropout_p > 0.0 and training
    if attn_mask is None and not use_dropout:
        return sdpa_raw(query, key, value, causal=is_causal, scale=scale)
    why = [w for w, on in (("attn_mask", attn_mask is not None),
                           (f"dropout_p={dropout_p} in training",
                            use_dropout)) if on]
    _record("plain", " and ".join(why) + ": the plain composite, as in "
            "the JAX package")
    return _plain_sdpa(query, key, value, causal=is_causal, scale=scale,
                       mask=attn_mask,
                       dropout_p=dropout_p if use_dropout else 0.0)
