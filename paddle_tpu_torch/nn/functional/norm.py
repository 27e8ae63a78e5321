"""Normalisation functionals. Counterpart of
``paddle_tpu/nn/functional/norm.py`` (``layer_norm``, ``batch_norm``,
``rms_norm``, ``group_norm``, ``instance_norm``, ``local_response_norm``,
``normalize``).

``group_norm`` and ``instance_norm`` compute in x's dtype, as the JAX
package does (no float32 statistics). ``local_response_norm`` sums the
squares over the channel window ``[c - size // 2, c + size // 2]``, JAX's
window, which for an even ``size`` is one channel wider than torch's;
the sum is still divided by ``size``. Channel axis 1 whatever
``data_format`` says, as in the JAX package.

``layer_norm``'s arithmetic is the JAX package's: mean and (population)
variance in float32 over the normalised axes, the normalised value cast
back to x's dtype, THEN times the weight, then plus the bias (in bf16
each step rounds as on the JAX side).

``batch_norm`` follows the JAX package's conventions, which are
paddle's: ``running = momentum * running + (1 - momentum) * batch``
(``momentum`` 0.9; torch's ``momentum`` is the complement), the running
variance unbiased (``n / (n - 1)``) while the normalisation divides by
the biased one, batch statistics in float32 whatever the activation
dtype, and the running buffers updated in place in their own dtype (a
bf16 model keeps bf16 buffers). The JAX package computes it with
``jnp`` outside any Pallas kernel; here it is
``torch.nn.functional.batch_norm`` (on the card cuDNN's kernels for fp32
parameters, torch's own for bf16 ones), which does all of that when the
weight, bias and buffers share one dtype, or when x alone is narrower
(under ``amp.auto_cast``). Another mix, such as the bf16
weight and bias over fp32 buffers that ``amp.decorate`` (O2) leaves,
which torch's op refuses, takes the same arithmetic written out
(``_batch_norm_plain``). Channels-last formats
(``NHWC``, ``NLC``, ``NDHWC``) are moved to channels-first views, which
for a contiguous channels-last tensor is torch's ``channels_last``
memory format: nothing is copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["batch_norm", "group_norm", "instance_norm", "layer_norm",
           "local_response_norm", "normalize", "rms_norm"]

_CHANNEL_LAST = ("NHWC", "NLC", "NWC", "NDHWC")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    dims = tuple(range(x.dim() - len(ns), x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _to_channels_first(x):
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_channels_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


def _batch_norm_plain(x, running_mean, running_var, weight, bias, use_batch,
                      momentum, epsilon):
    """The JAX package's arithmetic for x ``[N, C, ...]``, op by op."""
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    if use_batch:
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            running_mean.copy_(momentum * running_mean.float()
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var.float()
                              + (1 - momentum) * unbiased)
    else:
        mean, var = running_mean.float(), running_var.float()
    out = (xf - mean.reshape(shape)) * torch.rsqrt(
        var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalisation over every axis but the channel one. In
    training (unless ``use_global_stats``) it normalises with the batch's
    statistics and updates ``running_mean`` / ``running_var`` in place;
    otherwise it reads them."""
    channel_last = data_format in _CHANNEL_LAST
    use_batch = bool(training) and not use_global_stats
    xc = _to_channels_first(x) if channel_last else x
    rd = running_mean.dtype
    params = [t for t in (weight, bias) if t is not None]
    if all(t.dtype == rd for t in params) and running_var.dtype == rd \
            and (x.dtype == rd or rd == torch.float32):
        out = TF.batch_norm(xc, running_mean, running_var, weight, bias,
                            use_batch, 1.0 - momentum, epsilon)
    else:
        out = _batch_norm_plain(xc, running_mean, running_var, weight, bias,
                                use_batch, momentum, epsilon)
    return _to_channels_last(out) if channel_last else out


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """Mean of squares in float32, ``rsqrt``, cast back to x's dtype, then
    times the weight."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    nrm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


def _affine(out, weight, bias):
    shape = [1, out.shape[1]] + [1] * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial axes; the
    running statistics are not read or updated (as in the JAX package)."""
    dims = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return _affine((x - mean) * torch.rsqrt(var + eps), weight, bias)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format in _CHANNEL_LAST
    a = _to_channels_first(x) if channel_last else x
    n, c = a.shape[:2]
    g = a.reshape((n, num_groups, c // num_groups) + tuple(a.shape[2:]))
    var, mean = torch.var_mean(g, dim=tuple(range(2, g.dim())),
                               keepdim=True, correction=0)
    out = _affine(((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape),
                  weight, bias)
    return _to_channels_last(out) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    half = size // 2
    sq = TF.pad(x * x, (0, 0) * (x.dim() - 2) + (half, half))
    c = x.shape[1]
    acc = sum(sq[:, off:off + c] for off in range(2 * half + 1))
    return x / (k + alpha * acc / size) ** beta
