"""Pooling. Counterpart of ``paddle_tpu/nn/functional/pooling.py``
(max and average pooling in 1, 2 and 3 dimensions, and the adaptive
ones).

The JAX package lowers pooling to ``lax.reduce_window`` and adaptive
pooling to reshapes and means, outside any Pallas kernel; here they are
torch's pooling ops. The padding forms are the JAX package's (an int, one
per spatial dim, per-side pairs flattened, pairs per dim, the full-rank
form, "SAME" with XLA's split of an odd total, "VALID"). Max pooling
pads with -inf; average pooling with ``exclusive`` (the default) divides
each window's sum by the number of input elements in it, otherwise by
the kernel's size, and a "SAME" / "VALID" string always divides by the
kernel's size, as the JAX package does.

``ceil_mode`` is paddle's: the output is ``ceil((in + pads - k) / s) + 1``
long, the last window reaching past the padding (those positions count
as padding). The JAX package accepts ``ceil_mode`` and ignores it, so
the two agree only where ``ceil_mode`` does not change the output's
length (ROADMAP.md, Queue 3).

Adaptive pooling splits each spatial dim into paddle's bins: where the
length divides, equal bins of ``in / out``; otherwise bin ``i`` is
``[floor(i in / out), ceil((i + 1) in / out))``. ``output_size`` takes an
int, a sequence (``None`` keeps that dim), or a callable of the spatial
shape, as in the JAX package.

Channels-last formats (``NLC``, ``NHWC``, ``NDHWC``) are moved to
channels-first views: for a contiguous channels-last tensor that is
torch's ``channels_last`` memory format and nothing is copied.

``return_mask=True`` (max and adaptive max pooling) also returns the
mask, JAX's layout: for each output, the int32 flat index of its
maximum in the unpadded input's spatial plane (the first one on a tie).
As in the JAX package, a masked max pool's gradient goes to that index
and an adaptive one's splits evenly over the tied maxima.
It needs numeric padding and no ``ceil_mode``, as in the JAX package.
``max_unpool1d/2d/3d`` scatter the values back to those indices over a
zero plane of ``output_size`` (by default ``(in - 1) * stride - 2 * pad +
kernel``).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from .conv import _norm_tuple, _same_pads
from .norm import _CHANNEL_LAST, _to_channels_first, _to_channels_last

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
           "max_pool3d", "max_unpool1d", "max_unpool2d", "max_unpool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool_padding(padding, n, channel_last):
    """Every padding spelling as ``[(lo, hi)] * n``."""
    if isinstance(padding, (int, np.integer)):
        return [(int(padding),) * 2] * n
    padding = list(padding)
    if padding and isinstance(padding[0], (list, tuple)):
        if len(padding) == n + 2:       # full rank, batch and channel too
            spatial = padding[1:-1] if channel_last else padding[2:]
            return [(int(p[0]), int(p[1])) for p in spatial]
        if len(padding) == n:
            return [(int(p[0]), int(p[1])) for p in padding]
        raise ValueError(f"bad pool padding {padding!r}")
    if len(padding) == 2 * n:           # per side, flattened
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(int(p),) * 2 for p in _norm_tuple(padding, n)]


def _window_sum(x, n, ks, st):
    """Each window's sum (no padding, floor mode)."""
    if n == 1:
        return TF.avg_pool2d(x[..., None], (ks[0], 1), (st[0], 1),
                             divisor_override=1)[..., 0]
    return _AVG[n](x, ks, st, divisor_override=1)


def _pool_nd(x, n, kernel, stride, padding, kind, ceil_mode=False,
             exclusive=True, data_format="NCHW"):
    channel_last = data_format in _CHANNEL_LAST
    ks = _norm_tuple(kernel, n)
    st = _norm_tuple(stride if stride is not None else kernel, n)
    xc = _to_channels_first(x) if channel_last else x
    spatial = xc.shape[2:]
    by_kernel = not exclusive
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"bad pool padding {padding!r}")
        pads = (_same_pads(spatial, ks, st, (1,) * n) if p == "SAME"
                else [(0, 0)] * n)
        by_kernel = True
    else:
        pads = _pool_padding(padding, n, channel_last)
    if ceil_mode:
        # paddle's ceil length; the windows past the padding read padding
        outs = [math.ceil((s + lo + hi - k) / t) + 1
                for s, (lo, hi), k, t in zip(spatial, pads, ks, st)]
        pads = [(lo, max(hi, (o - 1) * t + k - s - lo))
                for s, (lo, hi), k, t, o in zip(spatial, pads, ks, st, outs)]
    even = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    if kind == "max":
        if even:
            out = _MAX[n](xc, ks, st, padding=tuple(lo for lo, _ in pads))
        else:
            out = _MAX[n](TF.pad(xc, flat, value=-math.inf), ks, st)
    elif even and n > 1:
        out = _AVG[n](xc, ks, st, padding=tuple(lo for lo, _ in pads),
                      count_include_pad=by_kernel)
    else:
        total = _window_sum(TF.pad(xc, flat), n, ks, st)
        if by_kernel:
            out = total / math.prod(ks)
        else:
            ones = torch.ones((1, 1) + tuple(spatial), dtype=xc.dtype,
                              device=xc.device)
            out = total / _window_sum(TF.pad(ones, flat), n, ks, st)
    return _to_channels_last(out) if channel_last else out


def _max_pool_with_mask(x, n, kernel, stride, padding, channel_last,
                        ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            "return_mask=True with ceil_mode=True is not supported")
    if isinstance(padding, str):
        raise NotImplementedError(
            f"return_mask=True requires integer padding, got {padding!r}")
    ks = _norm_tuple(kernel, n)
    st = _norm_tuple(stride if stride is not None else kernel, n)
    pd = _norm_tuple(padding, n)
    xc = _to_channels_first(x) if channel_last else x
    out, idx = _MAX[n](xc, ks, st, padding=pd, return_indices=True)
    idx = idx.to(torch.int32)
    if channel_last:
        return _to_channels_last(out), _to_channels_last(idx)
    return out, idx


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 1, kernel_size, stride, padding,
                                   data_format == "NLC", ceil_mode)
    return _pool_nd(x, 1, kernel_size, stride, padding, "max", ceil_mode,
                    data_format="NWC" if data_format == "NLC" else "NCW")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 2, kernel_size, stride, padding,
                                   data_format == "NHWC", ceil_mode)
    return _pool_nd(x, 2, kernel_size, stride, padding, "max", ceil_mode,
                    data_format=data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 3, kernel_size, stride, padding,
                                   data_format == "NDHWC", ceil_mode)
    return _pool_nd(x, 3, kernel_size, stride, padding, "max", ceil_mode,
                    data_format=data_format)


def _no_divisor(divisor_override):
    if divisor_override is not None:
        raise NotImplementedError(
            "avg_pool: divisor_override is not in the port yet (ROADMAP.md, "
            "port queue item 9)")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, 1, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive,
                    "NWC" if data_format == "NLC" else "NCW")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _no_divisor(divisor_override)
    return _pool_nd(x, 2, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _no_divisor(divisor_override)
    return _pool_nd(x, 3, kernel_size, stride, padding, "avg", ceil_mode,
                    exclusive, data_format)


def _adaptive_sizes(output_size, n, spatial):
    """``output_size`` as n ints: an int, a sequence (``None`` keeps that
    input dim), or a callable of the spatial shape."""
    if callable(output_size):
        return tuple(int(v) for v in output_size(spatial))
    if output_size is None:
        return tuple(int(s) for s in spatial)
    if isinstance(output_size, (list, tuple)):
        vs = (list(output_size) if len(output_size) == n
              else [output_size[0]] * n)
        return tuple(int(spatial[d]) if vs[d] is None else int(vs[d])
                     for d in range(n))
    return tuple(int(output_size) for _ in range(n))


def _adaptive_pool(x, n, output_size, kind, data_format="NCHW"):
    channel_last = data_format in _CHANNEL_LAST
    xc = _to_channels_first(x) if channel_last else x
    spatial = tuple(xc.shape[2:])
    sizes = _adaptive_sizes(output_size, n, spatial)
    reduce = ((lambda t, d: t.amax(dim=d)) if kind == "max"
              else (lambda t, d: t.mean(dim=d)))
    if all(o == 1 for o in sizes):
        out = reduce(xc, tuple(range(2, 2 + n)))
        out = out.reshape(out.shape + (1,) * n)
    elif all(s % o == 0 for s, o in zip(spatial, sizes)):
        shape = tuple(xc.shape[:2])
        for s, o in zip(spatial, sizes):
            shape += (o, s // o)
        out = reduce(xc.reshape(shape), tuple(3 + 2 * d for d in range(n)))
    else:
        out = xc
        for d in range(n):
            in_sz, out_sz, axis = spatial[d], sizes[d], 2 + d
            pieces = []
            for i in range(out_sz):
                lo = (i * in_sz) // out_sz
                hi = -((-(i + 1) * in_sz) // out_sz)
                seg = out.narrow(axis, lo, hi - lo)
                pieces.append(reduce(seg, (axis,)).unsqueeze(axis))
            out = torch.cat(pieces, dim=axis)
    return _to_channels_last(out) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, 1, output_size, "avg", "NCW")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, 2, output_size, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, 3, output_size, "avg", data_format)


def _adaptive_max_with_mask(x, n, output_size):
    """(the adaptive max, whose gradient splits evenly over tied maxima
    as the JAX package's ``jnp.max`` does, and torch's first-maximum
    indices)."""
    spatial = tuple(x.shape[2:])
    sizes = _adaptive_sizes(output_size, n, spatial)
    with torch.no_grad():
        _, idx = _ADAPTIVE_MAX[n](x, sizes, return_indices=True)
    if all(s % o == 0 for s, o in zip(spatial, sizes)):
        out = _adaptive_pool(x, n, sizes, "max", "NCHW")
    else:                   # each window's max over all its axes at once
        bins = [[(i * s // o, -(-(i + 1) * s // o)) for i in range(o)]
                for s, o in zip(spatial, sizes)]
        dims = tuple(range(2, 2 + n))
        cells = [x[(Ellipsis,) + tuple(slice(*b) for b in cell)].amax(dims)
                 for cell in itertools.product(*bins)]
        out = torch.stack(cells, dim=-1).reshape(tuple(x.shape[:2]) + sizes)
    return out, idx.to(torch.int32)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, 1, output_size)
    return _adaptive_pool(x, 1, output_size, "max", "NCW")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, 2, output_size)
    return _adaptive_pool(x, 2, output_size, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, 3, output_size)
    return _adaptive_pool(x, 3, output_size, "max", "NCDHW")


def _max_unpool(x, indices, n, kernel, stride, padding, output_size,
                channel_last):
    ks = _norm_tuple(kernel, n)
    st = _norm_tuple(stride if stride is not None else kernel, n)
    pd = _norm_tuple(padding, n)
    if channel_last:
        x, indices = _to_channels_first(x), _to_channels_first(indices)
    lead = tuple(x.shape[:2])
    if output_size is None:
        out_sp = [(x.shape[2 + i] - 1) * st[i] - 2 * pd[i] + ks[i]
                  for i in range(n)]
    else:
        out_sp = list(output_size)
    out_sp = tuple(int(s) for s in out_sp[-n:])
    flat = torch.zeros(lead + (math.prod(out_sp),), dtype=x.dtype,
                       device=x.device)
    out = flat.scatter(-1, indices.reshape(lead + (-1,)).long(),
                       x.reshape(lead + (-1,))).reshape(lead + out_sp)
    return _to_channels_last(out) if channel_last else out


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, data_format == "NLC")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, data_format == "NHWC")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, data_format == "NDHWC")
