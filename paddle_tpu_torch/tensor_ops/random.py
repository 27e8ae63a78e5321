"""Random ops. Counterpart of ``paddle_tpu/tensor_ops/random.py``.

Draws come from ``framework.random_seed.generator(device)``, so
``paddle_tpu_torch.seed(n)`` makes them repeat; the numbers differ from
the JAX package's for the same seed (Philox/mt19937, not threefry).
``uniform(seed=s)`` with ``s != 0`` draws from a generator of its own
seeded with ``s``.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device
from ..framework.random_seed import generator
from ._factory import int_list, operands, tensor

__all__ = ["bernoulli", "multinomial", "normal", "normal_like", "poisson",
           "rand", "rand_like", "randint", "randint_like", "randn",
           "randn_like", "randperm", "standard_normal", "uniform"]


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype) or dtype_mod.default_dtype()


def _draw(fill, shape, dtype, device=None):
    """A tensor of ``shape`` filled in place by ``fill(t, generator)``, on
    ``device`` (the framework's when None)."""
    dev = resolve_device(device) if not isinstance(
        device, torch.device) else device
    t = torch.empty(tuple(int_list(shape)), dtype=dtype, device=dev)
    return fill(t, generator(dev))


def rand(shape, dtype=None, name=None):
    return _draw(lambda t, g: t.uniform_(0.0, 1.0, generator=g), shape,
                 _dt(dtype))


def randn(shape, dtype=None, name=None):
    return _draw(lambda t, g: t.normal_(generator=g), shape, _dt(dtype))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = operands(mean, std)
        z = _draw(lambda t, g: t.normal_(generator=g),
                  torch.broadcast_shapes(m.shape, s.shape),
                  torch.promote_types(m.dtype, s.dtype), m.device)
        return m + s * z
    z = _draw(lambda t, g: t.normal_(generator=g),
              shape if shape is not None else [], dtype_mod.default_dtype())
    return mean + std * z


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device(None)
    t = torch.empty(tuple(int_list(shape)), dtype=_dt(dtype), device=dev)
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    else:
        g = generator(dev)
    return t.uniform_(min, max, generator=g)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return _draw(lambda t, g: t.random_(low, high, generator=g), shape,
                 dtype_mod.convert_dtype(dtype) or torch.int64)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = tensor(x)
    if high is None:
        low, high = 0, low
    return _draw(lambda t, g: t.random_(low, high, generator=g), x.shape,
                 dtype_mod.convert_dtype(dtype) or x.dtype, x.device)


def randperm(n, dtype="int64", name=None):
    dev = resolve_device(None)
    return torch.randperm(n, generator=generator(dev), device=dev).to(
        dtype_mod.convert_dtype(dtype))


def bernoulli(x, name=None):
    p = tensor(x)
    return torch.bernoulli(p, generator=generator(p.device))


def poisson(x, name=None):
    lam = tensor(x)
    return torch.poisson(lam, generator=generator(lam.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = tensor(x)
    return torch.multinomial(p, num_samples, replacement,
                             generator=generator(p.device))


def rand_like(x, dtype=None, name=None):
    x = tensor(x)
    return _draw(lambda t, g: t.uniform_(0.0, 1.0, generator=g), x.shape,
                 dtype_mod.convert_dtype(dtype) or x.dtype, x.device)


def randn_like(x, dtype=None, name=None):
    x = tensor(x)
    return _draw(lambda t, g: t.normal_(generator=g), x.shape,
                 dtype_mod.convert_dtype(dtype) or x.dtype, x.device)


def normal_like(x, mean=0.0, std=1.0, name=None):
    x = tensor(x)
    return mean + std * _draw(lambda t, g: t.normal_(generator=g), x.shape,
                              x.dtype, x.device)
