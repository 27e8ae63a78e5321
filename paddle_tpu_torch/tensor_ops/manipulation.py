"""Shape, layout and indexing ops. Counterpart of
``paddle_tpu/tensor_ops/manipulation.py``.

paddle's rules kept from the JAX package: a ``0`` in ``reshape``'s shape
copies the input's dim at that index; ``split`` takes a count (which
must divide the dim) or sections with one ``-1``; ``squeeze`` drops only
the named axes of size 1; ``scatter(overwrite=False)`` zeroes the
indexed rows, then adds every update into them; ``unique`` returns
``np.unique``'s outputs (the first index, the inverse, the counts);
``unique_consecutive`` with no axis works on the flattened input. Ops
whose output shape depends on the data (``masked_select``, ``nonzero``,
``unique``) read it on the device and stay differentiable where JAX's
are. Index results are int64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ._factory import (as_int, int_list, operands, promoted, stop, tensor)

__all__ = [
    "as_strided", "atleast_1d", "atleast_2d", "atleast_3d", "broadcast_tensors",
    "broadcast_to", "cast", "chunk", "concat", "crop", "expand", "expand_as",
    "fill_diagonal", "fill_diagonal_tensor", "flatten", "flip", "gather",
    "gather_nd", "index_add", "index_sample", "index_select", "masked_fill",
    "masked_select", "moveaxis", "nonzero", "put_along_axis",
    "repeat_interleave", "reshape", "roll", "rot90", "scatter", "scatter_nd",
    "scatter_nd_add", "shard_index", "slice", "split", "squeeze", "stack",
    "strided_slice", "swapaxes", "t", "take", "take_along_axis", "tensordot",
    "tile", "transpose", "unbind", "unique", "unique_consecutive",
    "unsqueeze", "unstack", "view", "view_as", "where",
]

builtins_slice = builtins.slice


def reshape(x, shape, name=None):
    """A ``0`` in ``shape`` copies the input's dim at that index."""
    x = tensor(x)
    shape = int_list(shape)
    return torch.reshape(x, [x.shape[i] if s == 0 and i < x.dim() else s
                             for i, s in enumerate(shape)])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def transpose(x, perm, name=None):
    return tensor(x).permute(*int_list(perm))


def t(x, name=None):
    x = tensor(x)
    return x if x.dim() < 2 else x.transpose(-1, -2)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(tensor(x), source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return tensor(x).transpose(axis1, axis2)


def concat(x, axis=0, name=None):
    return torch.cat(promoted(*x), dim=as_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(promoted(*x), dim=as_int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """A count that divides the dim, or sections (one may be ``-1``,
    inferred); a list of tensors."""
    x = tensor(x)
    axis = as_int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, (list, tuple, torch.Tensor)):
        secs = int_list(num_or_sections)
        n_free = builtins.sum(1 for s in secs if s == -1)
        rest = dim - builtins.sum(s for s in secs if s != -1)
        secs = [s if s != -1 else rest // builtins.max(1, n_free)
                for s in secs]
        if builtins.sum(secs) != dim:
            raise ValueError(f"split sections {num_or_sections} do not sum "
                             f"to dim size {dim} along axis {axis}")
    else:
        n = as_int(num_or_sections)
        if n <= 0 or dim % n:
            raise ValueError(f"split: {n} does not divide dim size {dim} "
                             f"along axis {axis}")
        secs = [dim // n] * n
    return list(torch.split(x, secs, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(tensor(x), dim=axis))


unstack = unbind


def squeeze(x, axis=None, name=None):
    """Drops every dim of size 1, or those of ``axis`` that have size 1."""
    x = tensor(x)
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a % x.dim() for a in int_list(axis)
                 if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    x = tensor(x)
    for ax in sorted(int_list(axis)):
        x = torch.unsqueeze(x, ax)
    return x


def tile(x, repeat_times, name=None):
    return torch.tile(tensor(x), tuple(int_list(repeat_times)))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; ``-1`` keeps the input's dim."""
    return tensor(x).expand(*int_list(shape))


def expand_as(x, y, name=None):
    return tensor(x).expand(tuple(tensor(y).shape))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(tensor(x), tuple(int_list(shape)))


def broadcast_tensors(input=None, name=None, inputs=None):
    return list(torch.broadcast_tensors(*operands(
        *(input if input is not None else inputs))))


def flip(x, axis, name=None):
    return torch.flip(tensor(x), int_list(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(tensor(x), k, list(axes))


def roll(x, shifts, axis=None, name=None):
    x = tensor(x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def gather(x, index, axis=0, name=None):
    """Rows (along ``axis``) at ``index``, flattened."""
    x = tensor(x)
    return torch.index_select(x, as_int(axis),
                              tensor(index, x.device).reshape(-1).long())


def _nd_index(index, device):
    idx = tensor(index, device).long()
    return tuple(idx.unbind(-1))


def gather_nd(x, index, name=None):
    x = tensor(x)
    return x[_nd_index(index, x.device)]


def take(x, index, mode="raise", name=None):
    """``x`` flattened, read at ``index``: "raise" refuses an index out of
    range, "wrap" takes it modulo the size, "clip" clamps it."""
    x = tensor(x)
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = tensor(index, x.device).long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif bool(((idx < -n) | (idx >= n)).any()):
        raise IndexError(f"take: an index is out of range for {n} "
                         f"elements")
    return flat[idx]


def take_along_axis(arr, indices, axis, name=None):
    a = tensor(arr)
    return torch.take_along_dim(a, tensor(indices, a.device).long(), axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    a = tensor(arr)
    idx = tensor(indices, a.device).long()
    v = torch.broadcast_to(tensor(values, a.device).to(a.dtype), idx.shape)
    if reduce == "assign":
        return torch.scatter(a, axis, idx, v)
    if reduce == "add":
        return torch.scatter_add(a, axis, idx, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(a, axis, idx, v, "prod")
    raise ValueError(reduce)


def index_select(x, index, axis=0, name=None):
    x = tensor(x)
    return torch.index_select(x, axis, tensor(index, x.device).long())


def index_sample(x, index, name=None):
    x = tensor(x)
    return torch.gather(x, 1, tensor(index, x.device).long())


def index_add(x, index, axis, value, name=None):
    x, v = operands(x, value)
    return x.index_add(axis, tensor(index, x.device).long(), v.to(x.dtype))


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (``overwrite``), or
    zeroed and then summed over the updates aimed at them."""
    x, u = operands(x, updates)
    idx = tensor(index, x.device).long().reshape(-1)
    u = u.to(x.dtype)
    if overwrite:
        return x.index_copy(0, idx, u)
    return x.index_fill(0, idx, 0).index_add(0, idx, u)


def scatter_nd_add(x, index, updates, name=None):
    x, u = operands(x, updates)
    return x.index_put(_nd_index(index, x.device), u.to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = tensor(updates)
    z = torch.zeros(tuple(int_list(shape)), dtype=u.dtype, device=u.device)
    return z.index_put(_nd_index(index, u.device), u, accumulate=True)


def masked_select(x, mask, name=None):
    x = tensor(x)
    return torch.masked_select(x, tensor(mask, x.device).bool())


def masked_fill(x, mask, value, name=None):
    x = tensor(x)
    v = tensor(value, x.device).to(x.dtype)
    return torch.where(tensor(mask, x.device).bool(), v, x)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``; with neither, the indices of
    the true elements (``nonzero(as_tuple=True)``)."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c, a, b = operands(condition, x, y)
    return torch.where(c.bool(), a, b)


def nonzero(x, as_tuple=False):
    x = tensor(x)
    if as_tuple:
        return tuple(stop(torch.nonzero(x, as_tuple=True)))
    return stop(torch.nonzero(x))


def _first_index(inverse, n_unique):
    """The first position of each unique value given the inverse map."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    out = torch.full((n_unique,), inverse.numel(), dtype=torch.int64,
                     device=inverse.device)
    return out.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``'s outputs: the sorted unique values (of the
    flattened input, or slices along ``axis``), then as asked the first
    index of each, the inverse map and the counts, in ``dtype``."""
    x = tensor(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    dt = dtype_mod.convert_dtype(dtype)
    outs = [vals]
    if return_index:
        outs.append(_first_index(inv, counts.shape[0]).to(dt))
    if return_inverse:
        outs.append((inv if axis is not None else inv.reshape(x.shape)
                     ).to(dt))
    if return_counts:
        outs.append(counts.to(dt))
    outs = stop(outs)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = tensor(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    dt = dtype_mod.convert_dtype(dtype)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(dt))
    if return_counts:
        outs.append(counts.to(dt))
    outs = stop(outs)
    return outs[0] if len(outs) == 1 else tuple(outs)


def cast(x, dtype):
    return tensor(x).to(dtype_mod.convert_dtype(dtype))


def _index(v):
    return as_int(v) if isinstance(v, torch.Tensor) else v


def _strided(x, axes, starts, ends, strides):
    """Python slicing per axis; a negative stride reads backwards."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        sl = builtins_slice(_index(s), _index(e), _index(st))
        if sl.step is None or sl.step > 0:
            idx = [builtins_slice(None)] * out.dim()
            idx[ax] = sl
            out = out[tuple(idx)]
        else:
            keep = list(range(out.shape[ax]))[sl]
            out = torch.index_select(out, ax, torch.tensor(
                keep, dtype=torch.int64, device=out.device))
    return out


def slice(x, axes, starts, ends, name=None):
    return _strided(tensor(x), axes, starts, ends, [None] * len(axes))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided(tensor(x), axes, starts, ends, strides)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = tensor(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = tensor(input)
    size = index_num // nshards
    return stop(torch.where(torch.div(a, size, rounding_mode="floor")
                            == shard_id, torch.remainder(a, size),
                            ignore_value))


def crop(x, shape=None, offsets=None, name=None):
    x = tensor(x)
    offs = int_list(offsets) if offsets is not None else [0] * x.dim()
    shp = int_list(shape) if shape is not None else list(x.shape)
    return x[tuple(builtins_slice(o, o + (s if s != -1 else x.shape[i] - o))
                   for i, (o, s) in enumerate(zip(offs, shp)))]


def tensordot(x, y, axes=2, name=None):
    """paddle's ``axes``: an int, a flat list of dims both operands
    contract, or a pair of lists (a single list applies to both)."""
    a, b = operands(x, y)
    ax = axes
    if isinstance(ax, torch.Tensor):
        ax = int_list(ax)
    if isinstance(ax, (list, tuple)):
        if builtins.all(isinstance(v, (int, np.integer)) for v in ax):
            ax = (list(ax), list(ax))
        elif len(ax) == 1:
            ax = (list(ax[0]), list(ax[0]))
        else:
            ax = tuple(list(v) if isinstance(v, (list, tuple)) else [v]
                       for v in ax)
    return torch.tensordot(a, b, dims=ax)


def view(x, shape_or_dtype, name=None):
    """A list or tuple reshapes; anything else casts (the JAX package's
    reading of a dtype)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, list(tensor(other).shape))


def as_strided(x, shape, stride, offset=0, name=None):
    x = tensor(x)
    return stop(torch.as_strided(x.contiguous(), tuple(shape), tuple(stride),
                                 offset).clone())


def _atleast(fn, inputs):
    outs = [fn(tensor(x)) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """The main diagonal (offset ``offset``) set to ``value``: 2-D (a tall
    matrix stops at ``cols * cols`` unless ``wrap``), or N-D with equal
    dims at offset 0."""
    a = tensor(x)
    if a.dim() < 2:
        raise ValueError("fill_diagonal expects ndim >= 2")
    dev = a.device
    if a.dim() == 2:
        rows, cols = a.shape
        ii = torch.arange(rows, device=dev)
        if wrap and rows > cols:
            jj = torch.remainder(ii, cols + 1) + offset
            valid = (jj >= 0) & (jj < cols)
        else:
            jj = ii + offset
            valid = (jj >= 0) & (jj < cols) & (ii * cols + jj < cols * cols)
        return a.index_put((ii[valid], jj[valid]), torch.tensor(
            value, dtype=a.dtype, device=dev))
    if len(set(a.shape)) != 1:
        raise ValueError("N-D fill_diagonal requires all dimensions equal")
    if offset != 0:
        raise ValueError("N-D fill_diagonal supports offset=0 only")
    idx = torch.arange(a.shape[0], device=dev)
    return a.index_put((idx,) * a.dim(), torch.tensor(value, dtype=a.dtype,
                                                       device=dev))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written onto the (``dim1``, ``dim2``) diagonal of ``x``; y's
    last dim runs along the diagonal, its leading dims over x's others."""
    a, b = operands(x, y)
    d1, d2 = dim1 % a.dim(), dim2 % a.dim()
    if d1 == d2:
        raise ValueError("dim1 and dim2 must differ")
    n1, n2 = a.shape[d1], a.shape[d2]
    k = offset
    n = builtins.min(n1, n2 - k) if k >= 0 else builtins.min(n1 + k, n2)
    ii = torch.arange(n, device=a.device) + (0 if k >= 0 else -k)
    jj = torch.arange(n, device=a.device) + (k if k >= 0 else 0)
    perm = [ax for ax in range(a.dim()) if ax not in (d1, d2)]
    want = tuple(a.shape[ax] for ax in perm) + (n,)
    if tuple(b.shape) != want:
        raise ValueError(f"the y shape should be {want}, got "
                         f"{tuple(b.shape)}")
    out = a.permute(*perm, d1, d2).clone()
    out[..., ii, jj] = b.to(a.dtype)
    return out.permute(*np.argsort(perm + [d1, d2]).tolist())
