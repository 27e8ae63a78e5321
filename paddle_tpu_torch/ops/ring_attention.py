"""Ring attention: exact attention over sequence shards. Counterpart of
``paddle_tpu/ops/ring_attention.py``.

Q/K/V are sharded along the sequence over the ``sep`` group, ``[B, L/n,
H, D]`` on each rank. Each rank attends its queries to the KV shard it
holds, and the KV shards rotate around the ring (``collective.ppermute``,
rank i to rank i + 1); the partial results merge by their log-sum-exp
(online softmax), so the result is exact. The backward is a second ring
pass: dq accumulates locally while the (dk, dv) partial sums travel with
the rotating KV shards, and after n rotations they are home. It
recomputes each chunk pair's ``p = exp(s - lse)`` from the merged global
``lse`` and ``delta = rowsum(dO * O)``.

Chunk pairs run on the hand-written flash kernels where the JAX package
runs its Pallas kernel (a chunk of at least 128 positions; here also a
head dim in ``HEAD_DIMS``, bf16 or fp32): the forward through
``flash_attention`` (row 1, its ``lse`` kept), the backward through
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (rows 2-3)
given the merged ``lse``. CUDA tensors launch the kernels, CPU tensors
take their plain versions; other chunks take ``_chunk_attn_xla`` and its
gradient twin.

Differences from the JAX package, none of which changes a number:

- ``lse`` is ``[B, H, L]`` (the kernels' layout), not ``[B, L, H]``;
  the kernel's finite mask value on a fully masked row becomes -inf.
- Under causal masking the JAX ring computes the wraparound pairs (a KV
  chunk from a later rank) and masks them out. Here they are not
  launched: merging ``(0, -inf)`` and adding a zero gradient are exact
  identities. Every rank still makes every rotation, so rank ``idx``
  launches ``idx + 1`` chunk pairs forward and as many dq and dk/dv
  pairs backward (``n`` each without causal masking).
- ``o`` is rounded to q's dtype at every merge, as the JAX ``_merge``
  rounds it; the backward sums the chunk gradients in fp32, and the
  kernels return each chunk's dq, dk, dv in q's dtype.

``ring_attention_local`` runs on this rank's shards (the JAX body under
``shard_map``); ``ring_attention`` takes whole arrays on every rank,
runs the ring on this rank's shard and gathers the output.

Layouts follow paddle flash-attn: ``[batch, seq, heads, head_dim]``.
"""
from __future__ import annotations

import math

import torch

from ..distributed import collective as C
from ..distributed.mesh import sep_guard
from .flash_attention import (HEAD_DIMS, MASK_VALUE, attention_delta,
                              flash_attention, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq)

__all__ = ["ring_attention", "ring_attention_local", "on_sequence_shards"]

_NEG_INF = float("-inf")


def _flash_ok(q):
    """The JAX rule for the flash kernel on a chunk pair (a chunk of at
    least 128 positions), with the head dims and dtypes the kernels are
    built for."""
    return (q.shape[1] >= 128 and q.shape[-1] in HEAD_DIMS
            and q.dtype in (torch.bfloat16, torch.float32))


def _causal_mask(lq, lk, device):
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(
        diagonal=lk - lq)


def _heads(x, rep=1):
    """[B, L, H, D] -> fp32 [B, H * rep, L, D]."""
    x = x.transpose(1, 2).float()
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _chunk_attn_xla(q, k, v, scale, causal):
    """The plain chunk pair: (out [B, L, H, D] in q's dtype, lse [B, H,
    L] fp32, -inf on a row that sees no key), all in fp32."""
    rep = q.shape[2] // k.shape[2]
    qh, kh, vh = _heads(q) * scale, _heads(k, rep), _heads(v, rep)
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if causal:
        cm = _causal_mask(s.shape[-2], s.shape[-1], q.device)
        s = s.masked_fill(~cm, _NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = p.masked_fill(~cm, 0.0)
    l = p.sum(dim=-1)
    o = torch.matmul(p, vh) / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)),
                      _NEG_INF)
    return o.transpose(1, 2).to(q.dtype), lse


def _chunk_attn(q, k, v, scale, causal):
    """One chunk pair: row 1 (the flash forward, out and lse) where the
    rule admits it, else the plain version."""
    if _flash_ok(q):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale)
        return o, torch.where(lse <= 0.5 * MASK_VALUE, _NEG_INF, lse)
    return _chunk_attn_xla(q, k, v, scale, causal)


def _merge(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions (online softmax); o in
    [B, L, H, D] is rounded to o1's dtype, lse [B, H, L] stays fp32."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.exp(lse1 - m_safe)          # exp(-inf) = 0 for absent parts
    w2 = torch.exp(lse2 - m_safe)
    l = w1 + w2
    l_safe = l.clamp_min(1e-30)
    a1 = (w1 / l_safe).transpose(1, 2)[..., None]
    a2 = (w2 / l_safe).transpose(1, 2)[..., None]
    o = o1.float() * a1 + o2.float() * a2
    lse = torch.where(l > 0, m_safe + torch.log(l_safe), _NEG_INF)
    return o.to(o1.dtype), lse


def _chunk_grads_xla(q, k, v, do, lse, delta, scale, causal):
    """The plain chunk-pair gradients (the JAX ``_chunk_grads``): fp32
    (dq, dk, dv), dk and dv summed over each kv head's query heads."""
    B, _, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qh, kh, vh = _heads(q), _heads(k, rep), _heads(v, rep)
    doh = _heads(do)
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(s.shape[-2], Lk, q.device), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    if rep > 1:
        dk = dk.reshape(B, Hkv, rep, Lk, D).sum(2)
        dv = dv.reshape(B, Hkv, rep, Lk, D).sum(2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _chunk_grads(q, k, v, do, lse, delta, scale, causal):
    """One chunk pair's (dq, dk, dv) from the merged ``lse`` and
    ``delta`` ([B, Hq, Lq] fp32): rows 2-3 where the rule admits it, else
    the plain version."""
    if _flash_ok(q):
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         scale)
        return dq, dk, dv
    return _chunk_grads_xla(q, k, v, do, lse, delta, scale, causal)


def _kept(idx, s, causal):
    """Whether rank ``idx`` attends the KV chunk it holds at ring step
    ``s``, chunk ``(idx - s) mod n``: every one without causal masking;
    under it the diagonal (s = 0, causal within the chunk) and the
    earlier chunks (s <= idx), not the wraparound ones."""
    return not causal or s <= idx


def _ring_fwd_pass(q, k, v, group, causal, scale):
    """(o [B, L, H, D] in q's dtype, lse [B, H, L] fp32) of this rank's
    queries against every KV shard of the ring."""
    n, idx = group.nranks, group.rank
    o = lse = None
    for s in range(n):
        if _kept(idx, s, causal):
            o_c, lse_c = _chunk_attn(q, k, v, scale, causal and s == 0)
            o, lse = (o_c, lse_c) if o is None else _merge(o, lse, o_c,
                                                           lse_c)
        if s != n - 1:
            k, v = C.ppermute([k, v], 1, group)
    return o, lse


def _ring_bwd_pass(q, k, v, o, lse, do, group, causal, scale):
    """(dq, dk, dv) of this rank's shards: the chunk gradients summed in
    fp32, dk and dv rotated with their KV shards n times, home."""
    n, idx = group.nranks, group.rank
    do = do.contiguous()
    delta = attention_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for s in range(n):
        if _kept(idx, s, causal):
            dq_c, dk_c, dv_c = _chunk_grads(q, k, v, do, lse, delta, scale,
                                            causal and s == 0)
            dq += dq_c
            dk += dk_c
            dv += dv_c
        if s != n - 1:
            k, v, dk, dv = C.ppermute([k, v, dk, dv], 1, group)
        else:
            dk, dv = C.ppermute([dk, dv], 1, group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward ring saves (q, k, v, o, lse),
    the backward ring runs from them."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        o, lse = _ring_fwd_pass(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd_pass(q, k, v, o, lse, do, ctx.group,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention_local(q, k, v, group, causal=False, scale=None):
    """Exact attention over sequence shards: q/k/v are this rank's
    ``[B, L/n, H, D]`` shards along the ``group`` ring (group rank i holds
    block i); returns this rank's output shard. Every rank of the group
    calls it."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _RingAttention.apply(q, k, v, group, causal, scale)


class _Shard(torch.autograd.Function):
    """This rank's block of a replicated tensor along dim 1; the backward
    gathers the blocks' gradients (the replicated tensor's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        k = x.shape[1] // group.nranks
        return x[:, group.rank * k:(group.rank + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, g):
        return C.gather_dim(g.contiguous(), 1, ctx.group), None


class _Gather(torch.autograd.Function):
    """The blocks of every rank along dim 1; the backward keeps this
    rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.gather_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[1] // ctx.group.nranks
        r = ctx.group.rank
        return g[:, r * k:(r + 1) * k].contiguous(), None


def on_sequence_shards(body, q, k, v, mesh, axis_name, causal, scale):
    """``body(q, k, v, group, causal, scale)`` on this rank's shards of
    whole arrays [B, L, H, D] (the same on every rank), the output
    gathered: the JAX ``shard_map`` over ``axis_name`` in SPMD. L must
    divide by the axis size; n == 1 is plain attention."""
    if mesh is None:
        from ..distributed.mesh import get_mesh
        mesh = get_mesh()
    n = mesh.axis_size(axis_name)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if n == 1:
        from ..nn.functional.attention import sdpa_raw
        return sdpa_raw(q, k, v, causal=causal, scale=float(scale))
    if q.shape[1] % n:
        raise ValueError(f"seq len {q.shape[1]} not divisible by {n}")
    sep_guard(mesh, axis_name)
    group = mesh.group(axis_name)
    out = body(_Shard.apply(q, group), _Shard.apply(k, group),
               _Shard.apply(v, group), group, causal, float(scale))
    return _Gather.apply(out, group)


def ring_attention(q, k, v, mesh=None, axis_name="sep", causal=False,
                   scale=None):
    """Ring attention on whole arrays ``[B, L, H, D]`` held by every rank
    (the mesh's, by default ``get_mesh()``): the ring runs on this rank's
    shard, and the output is gathered. L must divide by the
    ``axis_name`` size."""
    return on_sequence_shards(ring_attention_local, q, k, v, mesh,
                              axis_name, causal, scale)
