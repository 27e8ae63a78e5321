"""Stochastic rounding to bf16 and to int8: wrappers of
``csrc/stochastic_round.cu``.

Counterparts of the two TPU kernels in ``paddle_tpu/nn/quant/__init__.py``
(``stochastic_round``, ``quantize_int8_stochastic``); the public functions
with the JAX package's signatures and dtype gating live in
``nn/quant/__init__.py`` and call these.

Random words come from threefry2x32 (20 rounds), keyed by ``(k0, k1) =
((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)`` (so ``(0, seed)`` for a
seed in ``[0, 2^32)``). Element ``i`` of the flattened input takes word
``i % 2`` of the block for counter ``(i // 2 & 0xFFFFFFFF, i // 2 >>
32)``: the words depend on the element index and the seed only. The
kernels compute the same function in CUDA; the plain versions here take
the words as an explicit tensor (``random_bits``), so the card compares
the two bit for bit, and a test can hand both all-zero words.

- ``threefry2x32(k0, k1, x0, x1)``: the block function on int64 tensors
  holding uint32 values (``& 0xFFFFFFFF`` after every add).
- ``random_bits(seed, n)``: the ``n`` words, int64 holding uint32.
- ``stochastic_round_bf16(x, seed)`` / ``..._reference(x, words)``:
  ``bf16_bits = (bits(x) + (word >> 16)) >> 16`` on the uint32 view, the
  add wrapping as an int32 add does. Exactly one of the two bf16 values
  around x, rounding away from zero with probability equal to the
  dropped fraction.
- ``quantize_int8_stochastic(x, seed)`` / ``..._reference(x, words)``:
  ``s = max(max|x| / 127, 1e-10)``, ``q = clip(floor(x / s + (word >> 8)
  * 2^-24), -127, 127)`` -> ``(int8 like x, fp32 [1, 1])``. A subnormal x
  or x / s counts as a zero of its sign, as f32 arithmetic on the TPU
  (and XLA on the CPU) flushes it.

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version with ``random_bits``. ``.launches`` on each kernel wrapper counts
its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .int8_matmul import div

__all__ = ["threefry2x32", "random_bits", "stochastic_round_bf16",
           "stochastic_round_bf16_reference", "quantize_int8_stochastic",
           "quantize_int8_stochastic_reference"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SR_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
_Q_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_uint,
                                       ctypes.c_uint, ctypes.c_void_p]


def seed_key(seed: int):
    """The threefry key ``(k0, k1)`` of an integer seed."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32, 20 rounds: key ``(k0, k1)`` (ints, or int64 tensors
    of uint32 values that broadcast against the counters), counters ``x0,
    x1`` (int64 tensors of uint32 values) -> two int64 tensors of uint32
    words."""
    if not isinstance(k0, torch.Tensor):
        k0, k1 = int(k0) & M32, int(k1) & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def random_bits(seed: int, n: int, device="cpu"):
    """The ``n`` random words of ``seed``, as the kernels draw them: int64
    tensor of uint32 values."""
    k0, k1 = seed_key(seed)
    p = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, p & M32, p >> 32)
    return torch.stack([y0, y1], dim=1).reshape(-1)[:n]


def _u32(x):
    """The uint32 view of fp32 ``x`` as int64."""
    return x.float().contiguous().view(torch.int32).long() & M32


def stochastic_round_bf16_reference(x, words):
    """The plain version: fp32 ``x`` -> bf16 with the given words (int64
    of uint32, one per element of ``x``)."""
    w = words.reshape(x.shape).to(x.device)
    hi = ((_u32(x) + (w >> 16)) & M32) >> 16
    return (hi - (hi >= 0x8000).long() * 0x10000).to(torch.int16).view(
        torch.bfloat16)


def _ftz(t):
    """Subnormals as zeros of their sign."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny, t * 0, t)


def quantize_int8_stochastic_reference(x, words):
    """The plain version: fp32 ``x`` -> (int8, fp32 scale ``[1, 1]``) with
    the given words."""
    xf = x.float()
    scale = torch.clamp_min(div(xf.abs().max(), 127.0), 1e-10)
    u = (words.reshape(x.shape).to(x.device) >> 8).float() * 2.0 ** -24
    q = torch.floor(_ftz(_ftz(xf) / scale) + u)
    q = torch.clamp(q, -127.0, 127.0).to(torch.int32).to(torch.int8)
    return q, scale.reshape(1, 1)


def _check(x, what):
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be on CUDA")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x is {x.dtype}; the kernel takes float32")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous x")


def stochastic_round_bf16(x, seed: int = 0):
    """fp32 ``x`` -> bf16, stochastically rounded with the words of
    ``seed``."""
    if not x.is_cuda:
        return stochastic_round_bf16_reference(x, random_bits(seed,
                                                              x.numel()))
    _check(x, "stochastic_round")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return out
    fn = _build.load("stochastic_round", "stochastic_round_bf16",
                     _SR_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), *seed_key(seed),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "stochastic_round")
    stochastic_round_bf16.launches += 1
    return out


def quantize_int8_stochastic(x, seed: int = 0):
    """fp32 ``x`` -> (int8, fp32 scale ``[1, 1]``): per-tensor abs-max
    scale, stochastic rounding with the words of ``seed``."""
    if not x.is_cuda:
        return quantize_int8_stochastic_reference(
            x, random_bits(seed, x.numel()))
    _check(x, "quantize_int8_stochastic")
    if x.numel() == 0:
        raise ValueError("quantize_int8_stochastic: empty input (max|x| "
                         "has no value)")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    amax = torch.zeros(1, dtype=torch.int32, device=x.device)
    fn = _build.load("stochastic_round", "quantize_int8_stochastic",
                     _Q_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 amax.data_ptr(), x.numel(), *seed_key(seed),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "quantize_int8_stochastic")
    quantize_int8_stochastic.launches += 1
    return q, scale


#: kernel launches since the counts were last reset (CPU calls not counted)
stochastic_round_bf16.launches = 0
quantize_int8_stochastic.launches = 0
