"""Statistics ops. Counterpart of ``paddle_tpu/tensor_ops/stat.py``.

``median`` averages the two middle values of an even count (the JAX
package's ``jnp.median``; ``torch.median`` would return the lower one),
as ``quantile`` interpolates linearly. Integer inputs compute in the
default float dtype.
"""
from __future__ import annotations

import torch

from ._factory import dims, floating, tensor
from .math import mean

__all__ = ["corrcoef", "cov", "median", "nanmedian", "nanquantile",
           "numel", "quantile", "std", "var", "mean"]


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = floating(tensor(x))
    return torch.std(x, dims(axis, x.dim()), correction=int(unbiased),
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = floating(tensor(x))
    return torch.var(x, dims(axis, x.dim()), correction=int(unbiased),
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (torch.quantile / nanquantile) over the axes of ``axis``:
    they are moved last and flattened into one."""
    x = floating(tensor(x))
    d = dims(axis, x.dim())
    rest = [i for i in range(x.dim()) if i not in d]
    flat = x.permute(*rest, *d).reshape(*[x.shape[i] for i in rest], -1)
    qt = q if isinstance(q, float) else torch.as_tensor(
        q, dtype=x.dtype).to(x.device)
    out = fn(flat, qt, dim=-1)
    if keepdim:
        shape = [1 if i in d else s for i, s in enumerate(x.shape)]
        out = out.reshape(*out.shape[:out.dim() - len(rest)], *shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def numel(x, name=None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"The type of 'x' in numel must be Tensor, but "
                        f"received {type(x)}")
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def corrcoef(x, rowvar=True, name=None):
    x = floating(tensor(x))
    return torch.corrcoef(x if rowvar else x.t())


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = floating(tensor(x))
    fw = tensor(fweights, x.device) if fweights is not None else None
    aw = tensor(aweights, x.device) if aweights is not None else None
    return torch.cov(x if rowvar else x.t(), correction=int(bool(ddof)),
                     fweights=fw, aweights=aw)
