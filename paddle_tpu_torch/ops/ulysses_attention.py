"""Ulysses-style all-to-all sequence parallelism. Counterpart of
``paddle_tpu/ops/ulysses_attention.py``.

The complement of ring attention (``ops/ring_attention.py``): instead of
rotating KV shards around a ring, two all-to-alls re-shard the
activations. Sequence-sharded ``[B, L/n, H, D]`` becomes head-sharded
``[B, L, H/n, D]`` (``collective.all_to_all``, the JAX package's tiled
``lax.all_to_all``), each rank runs ordinary attention over the whole
sequence for its slice of the heads (``sdpa_raw``, so the flash kernels,
rows 1-3, where they apply), and the inverse all-to-all restores the
sequence sharding. The all-to-all is linear, and its backward is the
reverse all-to-all.

GQA with ``kvh % n == 0`` stays grouped through the collectives (rank
j's contiguous query heads map onto its contiguous kv heads); otherwise
K/V are repeated up to the query heads first.

Layouts follow paddle flash-attn: ``[batch, seq, heads, head_dim]``.
"""
from __future__ import annotations

import math

from ..distributed import collective as C
from .ring_attention import on_sequence_shards

__all__ = ["ulysses_attention", "ulysses_attention_local"]


def _seq_to_head(x, group):
    """[B, L/n, H, D] -> [B, L, H/n, D]."""
    return C.all_to_all(x, 2, 1, group)


def _head_to_seq(x, group):
    """[B, L, H/n, D] -> [B, L/n, H, D]."""
    return C.all_to_all(x, 1, 2, group)


def ulysses_attention_local(q, k, v, group, causal=False, scale=None):
    """This rank's body: q/k/v are its ``[B, L/n, H, D]`` shards along the
    ``group`` (n ranks), with H % n == 0 (KV heads are repeated up where
    kvh % n != 0). Returns this rank's output shard."""
    from ..nn.functional.attention import sdpa_raw

    n = group.nranks
    h = q.shape[2]
    if h % n:
        raise ValueError(f"num heads {h} not divisible by axis size {n}")
    kvh = k.shape[2]
    rep = h // kvh if kvh != h else 1
    if kvh != h and h % kvh:
        raise ValueError(f"GQA heads {h} vs {kvh}")
    if rep > 1 and kvh % n:
        # uneven KV split: replicate up front (costlier collectives)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    out = sdpa_raw(_seq_to_head(q, group), _seq_to_head(k, group),
                   _seq_to_head(v, group), causal=causal, scale=scale)
    return _head_to_seq(out, group)


def ulysses_attention(q, k, v, mesh=None, axis_name="sep", causal=False,
                      scale=None):
    """All-to-all sequence-parallel attention on whole arrays ``[B, L, H,
    D]`` held by every rank (the mesh's, by default ``get_mesh()``): L and
    H must divide by the ``axis_name`` size."""
    if mesh is None:
        from ..distributed.mesh import get_mesh
        mesh = get_mesh()
    n = mesh.axis_size(axis_name)
    if n > 1 and q.shape[1] % n == 0 and q.shape[2] % n:
        raise ValueError(f"num heads {q.shape[2]} not divisible by {n}")
    return on_sequence_shards(ulysses_attention_local, q, k, v, mesh,
                              axis_name, causal, scale)
