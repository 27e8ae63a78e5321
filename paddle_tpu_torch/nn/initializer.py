"""Parameter initialisers. Counterpart of
``paddle_tpu/nn/initializer/__init__.py`` for the ones the port's layers
use.

Each initialiser fills a float32 tensor in place from a
``torch.Generator`` (``init(t, generator)``), drawing the JAX package's
distribution; the numbers differ from JAX's for the same seed, so tests
carry weights across with ``framework.io.load_numpy_state_dict``. Fans
follow the JAX package's ``_fans`` rule, which for 3-D and larger
shapes is not torch's: ``[E, d, f]`` (the MoE expert banks) has
``fan_in = d * f`` and ``fan_out = E * f``.
"""
from __future__ import annotations

import math

__all__ = ["Constant", "KaimingUniform", "Normal", "TruncatedNormal",
           "Uniform", "XavierUniform"]


def _fans(shape):
    """(fan_in, fan_out) of ``shape`` as the JAX package computes them."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, t, generator):
        return t.fill_(self.value)


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, t, generator):
        return t.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal:
    """N(mean, std) cut to ``mean +- 2 std``: a standard normal truncated
    to [-2, 2] (inverse CDF of a uniform draw), scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, t, generator):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return t.mul_(self.std).add_(self.mean)


class Uniform:
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, t, generator):
        return t.uniform_(self.low, self.high, generator=generator)


class KaimingUniform:
    """U(-limit, limit), ``limit = gain * sqrt(3 / fan_in)`` with the
    leaky-relu gain ``sqrt(2 / (1 + negative_slope ** 2))``."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, t, generator):
        fi = self.fan_in or _fans(t.shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return t.uniform_(-limit, limit, generator=generator)


class XavierUniform:
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator):
        fi, fo = _fans(t.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return t.uniform_(-limit, limit, generator=generator)
