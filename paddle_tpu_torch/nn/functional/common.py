"""Common functionals. Counterpart of
``paddle_tpu/nn/functional/common.py``: ``linear``, the dropouts, ``pad``,
``interpolate``, ``embedding``, ``one_hot`` and the rest.

``linear`` is an amp cast site: its operands pass
``amp.maybe_cast_compute``, as in the JAX package.

``pad`` takes the JAX package's two forms: a pair for every axis in axis
order (``len(pad) == 2 * x.ndim``), or pairs for the spatial axes from
the last one inwards. "reflect", "replicate" and "circular" are index
gathers with ``jnp.pad``'s rules (a reflection longer than the axis
reflects again), so any axis and any width work.

``interpolate`` is ``jax.image.resize``'s arithmetic, not
``torch.nn.functional.interpolate``'s: "nearest" samples at half-pixel
centres (``floor((i + 0.5) * in / out)``); the linear and cubic modes are
``scale_and_translate``'s separable weight matrices (a triangle kernel,
Keys' cubic with a = -0.5, and when the axis shrinks the kernel widened by
``in / out``, an antialiasing filter), one matmul an axis. The linear
modes with ``align_corners`` use the JAX package's own corner-aligned
gather, and "area" is adaptive average pooling.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import maybe_cast_compute
from ...framework.random_seed import generator

__all__ = ["alpha_dropout", "bilinear", "cosine_similarity", "dropout",
           "dropout2d", "dropout3d", "embedding", "fold", "interpolate",
           "label_smooth", "linear", "one_hot", "pad", "pairwise_distance",
           "unfold", "upsample", "zeropad2d"]

_MODES = ("upscale_in_train", "downscale_in_infer", "downgrade_in_infer")


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``, weight ``[in, out]`` (paddle layout); under
    ``amp.auto_cast`` fp32 operands are cast to the amp dtype first."""
    x, weight = maybe_cast_compute(x, weight)
    y = x @ weight
    return y if bias is None else y + bias.to(y.dtype)


def _check_p(p, op):
    if isinstance(p, bool) or not isinstance(p, (int, float)):
        raise TypeError(f"{op}: p argument should be a number")
    if not 0 <= p <= 1:
        raise ValueError(f"{op}: p argument should between 0 and 1, got {p}")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Drop each element (or each slice along ``axis``) with probability
    ``p``. The keep mask is drawn from ``framework.random_seed``'s
    generator for x's device, so ``seed(n)`` repeats it (the numbers are
    not the JAX package's). "upscale_in_train" scales the kept elements
    by ``1 / (1 - p)`` in training and is the identity otherwise;
    "downscale_in_infer" (also spelt "downgrade_in_infer") keeps them as
    they are and scales by ``1 - p`` outside training."""
    _check_p(p, "dropout")
    if mode not in _MODES:
        raise ValueError("dropout: mode should be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    upscale = mode == "upscale_in_train"
    if not training or p == 0:
        return x * (1.0 - p) if not upscale and p > 0 else x
    if p == 1:
        return x * 0.0
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = torch.rand(shape, generator=generator(x.device),
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p) if upscale else x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drops whole channels of ``[N, C, H, W]`` (``NHWC``)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"dropout2d: data_format should be 'NCHW' or "
                         f"'NHWC', got {data_format!r}")
    if x.dim() != 4:
        raise ValueError(f"dropout2d: dimensions of x should be 4, got "
                         f"{x.dim()}")
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Drops whole channels of ``[N, C, D, H, W]`` (``NDHWC``)."""
    if data_format not in ("NCDHW", "NDHWC"):
        raise ValueError(f"dropout3d: data_format should be 'NCDHW' or "
                         f"'NDHWC', got {data_format!r}")
    if x.dim() != 5:
        raise ValueError(f"dropout3d: dimensions of x should be 5, got "
                         f"{x.dim()}")
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped element becomes ``-alpha * scale``, then
    an affine map keeps the mean and variance."""
    _check_p(p, "alpha_dropout")
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, generator=generator(x.device),
                      device=x.device) < 1.0 - p
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


def _ints(v):
    if isinstance(v, torch.Tensor):
        return [int(t) for t in v.reshape(-1).tolist()]
    return [int(t.item() if isinstance(t, torch.Tensor) else t) for t in v]


def _pad_index(n, lo, hi, mode, device):
    """The source index of each of ``lo + n + hi`` padded positions."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if n == 1:                              # reflect
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad ``x``: ``pad`` is a pair for every axis (axis order), or pairs
    for the spatial axes from the last inwards ("NC..." formats: axes 2
    on; channels-last: 1 to -2). Modes "constant" (with ``value``),
    "reflect", "replicate" and "circular"."""
    pd = _ints(pad)
    nd = x.dim()
    if len(pd) == 2 * nd:
        widths = [(pd[2 * i], pd[2 * i + 1]) for i in range(nd)]
    else:
        widths = [(0, 0)] * nd
        spatial = (list(range(2, nd)) if data_format.startswith("NC")
                   else list(range(1, nd - 1)))
        for j in range(len(pd) // 2):
            widths[spatial[-(j + 1)]] = (pd[2 * j], pd[2 * j + 1])
    if mode == "constant":
        flat = [v for lo_hi in reversed(widths) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the indices ``x``; rows looked up at
    ``padding_idx`` are zeros (and pass no gradient)."""
    out = weight[x]
    if padding_idx is None:
        return out
    return torch.where((x == padding_idx)[..., None], 0.0, out)


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``; an index outside the classes gives
    a row of zeros, as ``jax.nn.one_hot``."""
    return (x[..., None] == torch.arange(num_classes, device=x.device)
            ).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


# -- interpolate ----------------------------------------------------------------
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _resize_weights(m, n, kernel, device):
    """``jax.image.compute_weight_mat`` for an axis of ``m`` resized to
    ``n`` (translation 0, antialias on), float32 ``[m, n]``."""
    f32 = torch.float32
    scale = torch.tensor(n / m, dtype=f32, device=device)
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        m, dtype=f32, device=device)[:, None]) / kscale
    w = kernel(dist)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_nearest_axis(a, axis, n):
    m = a.shape[axis]
    src = torch.floor((torch.arange(n, dtype=torch.float32, device=a.device)
                       + 0.5) * m / n).to(torch.int64)
    return a.index_select(axis, src)


def _resize_axis(a, axis, n, kernel):
    w = _resize_weights(a.shape[axis], n, kernel, a.device).to(a.dtype)
    return torch.movedim(torch.movedim(a, axis, -1) @ w, -1, axis)


def _interp_axis_align(a, axis, out_len):
    """The JAX package's corner-aligned linear gather along ``axis``."""
    in_len = a.shape[axis]
    if in_len == out_len:
        return a
    if out_len == 1 or in_len == 1:
        return a.index_select(axis, torch.zeros(out_len, dtype=torch.int64,
                                                device=a.device))
    coords = torch.linspace(0.0, in_len - 1, out_len, device=a.device)
    lo = torch.floor(coords).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_len - 1)
    shape = [1] * a.dim()
    shape[axis] = out_len
    w = (coords - lo).to(a.dtype).reshape(shape)
    return a.index_select(axis, lo) * (1 - w) + a.index_select(axis, hi) * w


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "trilinear": _triangle, "bicubic": _keys_cubic}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to ``size`` (or ``int(in * scale)``) with
    "nearest", "linear", "bilinear", "trilinear", "bicubic" or "area"."""
    mode = mode.lower()
    nchw = data_format.startswith("NC")
    nd = x.dim() - 2
    spatial = tuple(x.shape[2:] if nchw else x.shape[1:-1])
    if size is not None:
        out_size = tuple(_ints(size if isinstance(size, (list, tuple,
                                                         torch.Tensor))
                               else [size]))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * nd)
        out_size = tuple(int(d * s) for d, s in zip(spatial, sf))
    if mode == "area":
        from .pooling import _adaptive_pool
        df = data_format
        if nd == 1 and not nchw:
            df = "NWC"
        return _adaptive_pool(x, nd, list(out_size), "avg", df)
    if mode not in _KERNELS and mode != "nearest":
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    first = 2 if nchw else 1
    out = x
    for d, n in enumerate(out_size):
        axis = first + d
        if out.shape[axis] == n:
            continue
        if mode == "nearest":
            out = _resize_nearest_axis(out, axis, n)
        elif align_corners and mode != "bicubic":
            out = _interp_axis_align(out, axis, n)
        else:
            out = _resize_axis(out, axis, n, _KERNELS[mode])
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = torch.sum(x1 * x2, dim=axis)
    den = (torch.linalg.vector_norm(x1, dim=axis)
           * torch.linalg.vector_norm(x2, dim=axis))
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _fold_args(kernel_sizes, strides, paddings, dilations):
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    return _pair(kernel_sizes), _pair(strides), pd, _pair(dilations)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``. Four paddings
    pad H by (``p[0]``, ``p[2]``) and W by (``p[1]``, ``p[3]``)."""
    ks, st, pd, dl = _fold_args(kernel_sizes, strides, paddings, dilations)
    n, c = x.shape[:2]
    a = torch.nn.functional.pad(x, (pd[1], pd[3], pd[0], pd[2]))
    oh = (a.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (a.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = [a[:, :, i * dl[0]:i * dl[0] + oh * st[0]:st[0],
                 j * dl[1]:j * dl[1] + ow * st[1]:st[1]]
               for i in range(ks[0]) for j in range(ks[1])]
    return torch.stack(patches, dim=2).reshape(n, c * ks[0] * ks[1], oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, ``unfold``'s adjoint: overlapping patches are summed."""
    os_ = _pair(output_sizes)
    ks, st, pd, dl = _fold_args(kernel_sizes, strides, paddings, dilations)
    n, ckk = x.shape[:2]
    c = ckk // (ks[0] * ks[1])
    ph, pw = os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]
    oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    a = x.reshape(n, c, ks[0], ks[1], oh, ow)
    out = torch.zeros((n, c, ph, pw), dtype=x.dtype, device=x.device)
    for i in range(ks[0]):
        for j in range(ks[1]):
            di, dj = i * dl[0], j * dl[1]
            out[:, :, di:di + oh * st[0]:st[0],
                dj:dj + ow * st[1]:st[1]] += a[:, :, i, j]
    return out[:, :, pd[0]:ph - pd[2], pd[1]:pw - pd[3]]

