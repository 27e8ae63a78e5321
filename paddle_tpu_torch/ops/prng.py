"""Counter-based random numbers: the ``jax.random`` calls of sampling.

Counterpart of the ``jax.random`` functions that the serving engine and
``generate()`` call in the JAX package (``PRNGKey``, ``split``, ``bits``,
``uniform``, ``gumbel``, ``categorical``), on the threefry2x32 block
function of ``ops/stochastic_round.py``. The integer words equal JAX's bit
for bit in its partitionable threefry mode (``jax_threefry_partitionable``,
the default since JAX 0.5):

- a key is ``(k0, k1)``; ``prng_key(seed)`` is ``(0, seed mod 2^32)``;
- ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
- the 32-bit word of flat element ``i`` of a draw is ``y0 ^ y1`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
- ``uniform``: ``(word >> 9) | 0x3F800000`` read as fp32, minus 1.0,
  scaled to ``[minval, maxval)`` with one rounding (XLA's FMA), then
  ``max(minval, .)``;
- ``gumbel`` (JAX's default ``"low"`` mode): ``-log(-log(u))`` with ``u``
  uniform on ``[tiny, 1)``;
- ``categorical``: ``argmax(logits + gumbel)`` over the last axis.

Keys are int64 tensors holding uint32 values, shape ``[..., 2]``. Every
function broadcasts over the leading axes of its key: a ``[S, 2]`` key
tensor gives each row its own draw, which is what ``jax.vmap`` over
``split`` and ``categorical`` gives, while one ``[2]`` key over a
``[B, V]`` draw counts its elements flat over ``B * V``, as one JAX call
does. The float noise goes through ``log``, whose last bit may differ
from XLA's; the words never do.
"""
from __future__ import annotations

import numpy as np
import torch

from .stochastic_round import M32, threefry2x32

__all__ = ["prng_key", "split", "random_bits", "uniform", "gumbel",
           "categorical", "categorical_rows"]

_TINY = torch.finfo(torch.float32).tiny


def prng_key(seed, device="cpu"):
    """``jax.random.PRNGKey(seed)``: ``(0, seed mod 2^32)`` as int64 [2]."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _words(key, hi, lo):
    """threefry2x32 of ``key [..., 2]`` over counters ``hi``, ``lo`` [n]
    -> two int64 tensors ``[..., n]``."""
    return threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)


def split(key, n=2):
    """``jax.random.split``: ``key [..., 2]`` -> ``[..., n, 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = _words(key, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape):
    """``jax.random.bits`` (uint32): ``key [..., 2]`` -> int64 tensor of
    uint32 words, shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = _words(key, i >> 32, i & M32)
    return (y0 ^ y1).reshape(tuple(key.shape[:-1]) + shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in fp32 on ``[minval, maxval)``."""
    bits = ((random_bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    # the bounds in fp32 as host scalars (a device scalar made here would
    # be a host-to-device copy, which waits for the stream)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # XLA fuses ``floats * span + lo`` into one rounding (an FMA): the fp64
    # product is exact, and the fp64 sum rounded to fp32 gives the fused
    # result
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def gumbel(key, shape):
    """``jax.random.gumbel`` (``mode="low"``), fp32."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis with one
    ``[2]`` key: the noise counts flat over all of ``logits``. Returns
    int64 indices of shape ``logits.shape[:-1]``."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


def categorical_rows(keys, logits):
    """``jax.vmap(jax.random.categorical)(keys, logits)``: row ``s`` of
    ``logits [S, V]`` draws with its own key ``keys[s]`` (``[S, 2]``).
    Returns int64 ``[S]``."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
