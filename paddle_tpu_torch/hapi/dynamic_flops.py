"""``paddle.flops``. Counterpart of ``paddle_tpu/hapi/dynamic_flops.py``:
forward hooks on the layers of the counted types, one forward of zeros
at ``input_size`` in eval mode, and the same per-type counts (a Linear
``rows x in x out``, a conv ``output elements x in / groups x kh x kw``,
a norm twice its input, an activation its input, a pool its output)."""
from __future__ import annotations

import math

import torch

__all__ = ["flops"]


def _prod(shape):
    return math.prod(int(s) for s in shape) if len(shape) else 1


def _count_linear(layer, x, y):
    return _prod(x.shape) // x.shape[-1] * layer.weight.shape[0] \
        * layer.weight.shape[1]


def _count_conv(layer, x, y):
    return _prod(y.shape) * _prod(layer.weight.shape[1:])


def _count_norm(layer, x, y):
    return 2 * _prod(x.shape)


def _count_act(layer, x, y):
    return _prod(x.shape)


def _count_pool(layer, x, y):
    return _prod(y.shape)


def _count_embedding(layer, x, y):
    return 0


def _default_counters():
    from .. import nn
    return {nn.Linear: _count_linear, nn.Conv2D: _count_conv,
            nn.BatchNorm1D: _count_norm, nn.BatchNorm2D: _count_norm,
            nn.BatchNorm3D: _count_norm, nn.LayerNorm: _count_norm,
            nn.ReLU: _count_act, nn.GELU: _count_act,
            nn.AvgPool2D: _count_pool, nn.MaxPool2D: _count_pool,
            nn.AdaptiveAvgPool2D: _count_pool,
            nn.Embedding: _count_embedding}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total multiply-accumulate count of one forward at ``input_size``
    (float32 zeros on the device of the network's parameters)."""
    counters = _default_counters()
    if custom_ops:
        counters.update(custom_ops)
    records = []

    def make_hook(fn):
        def hook(lyr, inputs, output):
            x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            y = output[0] if isinstance(output, (tuple, list)) else output
            records.append((type(lyr).__name__, int(fn(lyr, x, y))))
        return hook

    handles = [m.register_forward_hook(make_hook(counters[type(m)]))
               for m in net.modules() if type(m) in counters]
    p = next(iter(net.parameters()), None)
    dev = p.device if p is not None else torch.device("cpu")
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=dev))
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    total = sum(f for _, f in records)
    if print_detail:
        for name, f in records:
            print(f"  {name:<24s} {f:>16,d}")
        print(f"Total FLOPs: {total:,d}")
    return total
