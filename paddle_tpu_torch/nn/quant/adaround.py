"""AdaRound: learned up-or-down weight rounding for PTQ. Counterpart of
``paddle_tpu/nn/quant/adaround.py``.

Per layer, alpha parametrises a rectified-sigmoid soft rounding ``h(alpha)
= clip(sigmoid(alpha) (ZETA - GAMMA) + GAMMA, 0, 1)``; Adam minimises the
reconstruction MSE of the layer output against the float layer plus an
annealed regulariser ``reg * sum(1 - |2h - 1|^beta)`` that pushes h to
{0, 1} (beta cosine-annealed from 20 to 2 after a 20% warm start without
it). The JAX package runs the loop as one ``lax.fori_loop``; here it is a
Python loop over autograd with the same schedule, Adam moments and bias
correction. The learned rounding is baked back into the float weight
exactly on the int8 grid and the grid is pinned on the layer
(``_adaround_scale``), so ``Int8Linear.from_linear`` reproduces it.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

GAMMA, ZETA = -0.1, 1.1


def _soft_rounding(alpha):
    """Rectified sigmoid h(alpha) in [0, 1]."""
    return torch.clamp(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA,
                       0.0, 1.0)


def adaround_weight(weight, inputs, scale, bits=8, num_iterations=500,
                    reg_param=0.01, beta_range=(20.0, 2.0),
                    warm_start=0.2, lr=1e-2):
    """Learn per-element rounding for one Linear weight.

    weight: ``[in, out]``; inputs: ``[N, in]`` calibration rows; scale:
    ``[1, out]`` (or scalar) symmetric int8 grid step. Returns the
    adarounded weight (weight's dtype), whose values sit exactly on the
    int8 grid.
    """
    weight = torch.as_tensor(weight)
    dev = weight.device
    w = weight.detach().float()
    x = torch.as_tensor(inputs, device=dev).detach().float()
    s = torch.as_tensor(scale, device=dev).detach().float()
    qmax = 2.0 ** (bits - 1) - 1
    wf = w / s
    floor_w = torch.floor(wf)
    frac = torch.clamp(wf - floor_w, 1e-4, 1.0 - 1e-4)
    # init so h(alpha0) == frac: the soft rounding starts at the weight
    alpha = -torch.log((ZETA - GAMMA) / (frac - GAMMA) - 1.0)
    orig_out = x @ w
    warm_end = warm_start * num_iterations
    start_beta, end_beta = beta_range
    m = torch.zeros_like(alpha)
    v = torch.zeros_like(alpha)
    f32 = np.float32
    for i in range(num_iterations):
        # the schedule in fp32, as the JAX loop computes it
        it = f32(i)
        warm = it < f32(warm_end)
        rel = f32(min(max((it - f32(warm_end))
                          / f32(max(num_iterations - warm_end, 1.0)),
                          0.0), 1.0))
        beta = f32(end_beta) + f32(0.5) * f32(start_beta - end_beta) * (
            f32(1.0) + f32(math.cos(f32(rel * f32(math.pi)))))
        with torch.enable_grad():          # also under a caller's no_grad
            a = alpha.detach().requires_grad_()
            qdq = torch.clamp(floor_w + _soft_rounding(a), -qmax, qmax) * s
            loss = torch.mean(torch.sum((x @ qdq - orig_out) ** 2, -1))
            if not warm:
                h = _soft_rounding(a)
                loss = loss + reg_param * torch.sum(
                    1.0 - torch.abs(2.0 * h - 1.0) ** float(beta))
            g, = torch.autograd.grad(loss, a)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / float(f32(1.0) - f32(0.9) ** (it + f32(1.0)))
        vh = v / float(f32(1.0) - f32(0.999) ** (it + f32(1.0)))
        alpha = alpha - lr * mh / (torch.sqrt(vh) + 1e-8)
    # hard rounding: h >= 0.5 rounds up (alpha's sign decides)
    up = (_soft_rounding(alpha) >= 0.5).float()
    rounded = torch.clamp(floor_w + up, -qmax, qmax) * s
    return rounded.to(weight.dtype)


def run_adaround(data_loader, model, max_batches=8, num_iterations=500,
                 reg_param=0.01, beta_range=(20.0, 2.0), warm_start=0.2,
                 lr=1e-2, max_rows=1024):
    """AdaRound every ``Linear`` of ``model``: collect each layer's
    calibration inputs with forward-pre-hooks (at most ``max_rows`` rows
    per layer), learn its rounding, bake the result into the float weight
    on the int8 grid and pin the grid on the layer (``_adaround_scale``)
    so ``Int8Linear.from_linear`` converts on the scale the rounding was
    learned on. Convolutions keep nearest rounding (a warning says so),
    as in the JAX package."""
    from ..layer.common import Linear
    from . import quantize_int8
    from .qat import _is_conv, calibration_pass

    captured = {}
    targets = [(n, m) for n, m in model.named_modules() if type(m) is Linear]
    if any(_is_conv(m) for m in model.modules()):
        warnings.warn(
            "run_adaround: Conv2D layers keep nearest rounding "
            "(AdaRound here optimizes Linear weights only)", stacklevel=2)

    def observe(name):
        def hook(layer, inputs):
            got = sum(r.shape[0] for r in captured.get(name, ()))
            if got >= max_rows:
                return
            xin = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            rows = xin.detach().float().reshape(-1, xin.shape[-1])
            captured.setdefault(name, []).append(rows[:max_rows - got])
        return hook

    calibration_pass(model, data_loader,
                     [(layer, observe(name)) for name, layer in targets],
                     max_batches=max_batches)

    for name, layer in targets:
        rows = captured.pop(name, None)
        if not rows:
            continue
        x = torch.cat(rows, dim=0)
        _, s = quantize_int8(layer.weight.detach(), axis=0)   # [1, out]
        w = adaround_weight(layer.weight.detach(), x, s,
                            num_iterations=num_iterations,
                            reg_param=reg_param, beta_range=beta_range,
                            warm_start=warm_start, lr=lr)
        with torch.no_grad():
            layer.weight.copy_(w)
        layer._adaround_scale = s               # pin the learned grid
    return model
