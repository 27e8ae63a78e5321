"""Search and sort ops. Counterpart of ``paddle_tpu/tensor_ops/search.py``.

Ties resolve as the JAX package resolves them: ``argsort`` and ``sort``
are stable ascending, and ``descending=True`` reverses that order (tied
elements come last-first); ``topk`` and ``kthvalue`` take the lower
index first among ties (``jax.lax.top_k``); ``mode`` is the smallest of
the most frequent values, with the index of its last occurrence. Index
results are int64 (``out_int32``/``dtype`` where the op takes one) and
carry no gradient; values are gathered at those indices, so their
gradient goes where JAX's does.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ._factory import as_int, operands, stop, tensor

__all__ = ["argmax", "argmin", "argsort", "bincount", "bucketize",
           "histogram", "kthvalue", "mode", "searchsorted", "sort", "topk"]


def _arg(fn, x, axis, keepdim, dtype):
    x = tensor(x)
    if axis is None:
        out = fn(x.reshape(-1))
    else:
        out = fn(x, axis, keepdim=keepdim)
    return stop(out.to(dtype_mod.convert_dtype(dtype)))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _order(x, axis, descending):
    idx = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(idx, [axis]) if descending else idx


def argsort(x, axis=-1, descending=False, name=None):
    return stop(_order(tensor(x), axis, descending))


def sort(x, axis=-1, descending=False, name=None):
    x = tensor(x)
    return torch.gather(x, axis, _order(x, axis, descending))


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """(values, indices) of the ``k`` largest (or smallest) along
    ``axis``; among ties the lower index first."""
    x = tensor(x)
    axis = -1 if axis is None else axis
    idx = torch.argsort(x, dim=axis, descending=largest,
                        stable=True).narrow(axis, 0, as_int(k))
    return torch.gather(x, axis, idx), stop(idx)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = tensor(x)
    idx = torch.argsort(x, dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.gather(x, axis, idx)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, stop(idx)


def mode(x, axis=-1, keepdim=False, name=None):
    """(values, indices): the most frequent value along ``axis`` (the
    smallest of equally frequent ones) and the index of its last
    occurrence."""
    x = tensor(x)
    ax = axis % x.dim()
    moved = torch.movedim(x, ax, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    n, length = rows.shape
    s = torch.sort(rows, dim=-1).values
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[:, 1:] = s[:, 1:] != s[:, :-1]
    run = torch.cumsum(starts.long(), dim=-1) - 1          # run id per slot
    counts = torch.zeros_like(run).scatter_add_(1, run, torch.ones_like(run))
    per_slot = torch.gather(counts, 1, run)
    best = torch.argmax(per_slot, dim=-1, keepdim=True)    # first = smallest
    vals = torch.gather(s, 1, best)
    pos = torch.arange(length, device=x.device).expand(n, length)
    last = torch.where(rows == vals, pos, -1).amax(-1)
    vals = vals.reshape(moved.shape[:-1])
    idx = last.reshape(moved.shape[:-1])
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return stop(vals), stop(idx)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, v = operands(sorted_sequence, values)
    return stop(torch.searchsorted(seq, v, out_int32=out_int32,
                                   right=right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    a, seq = operands(x, sorted_sequence)
    return stop(torch.searchsorted(seq, a, out_int32=out_int32,
                                   right=right))


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over [min, max] (the data's range
    when both are 0); the last bin includes its right edge. The counts
    are float32, as the JAX package returns them."""
    a = tensor(input)
    a = a.to(torch.float64 if a.dtype == torch.float64 else torch.float32)
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        a.min().item(), a.max().item())
    return stop(torch.histc(a, bins, lo, hi))


def bincount(x, weights=None, minlength=0, name=None):
    x = tensor(x)
    w = tensor(weights, x.device) if weights is not None else None
    out = torch.bincount(x, w, minlength)
    return stop(out.to(w.dtype) if w is not None else out)
