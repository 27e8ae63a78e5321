"""SGD, Momentum, Adam and AdamW. Counterpart of
``paddle_tpu/optimizer/algorithms.py`` (``SGD``, ``Momentum``, ``Adam``,
``AdamW``, ``_master_init``; the other algorithms are in the port's long
tail).

Each algorithm is one pure ``update_param`` over plain elementwise
PyTorch (the JAX update is XLA, not a kernel; ``torch.optim`` is not
used). With ``multi_precision`` (the default) a bf16 parameter keeps a
persistent fp32 master copy and fp32 moments, so updates smaller than a
bf16 ulp are not rounded away; the beta powers are fp32 scalars carried
in the state. Momentum keeps its velocity in the same accumulator dtype.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


def _acc_dtype(p, multi_precision):
    return torch.float32 if (multi_precision and p.dtype == torch.bfloat16) \
        else p.dtype


def _master_init(self, p, st):
    """A low-precision parameter's fp32 master copy (reference FusedAdam
    multi_precision)."""
    if self._multi_precision and p.dtype in (torch.bfloat16, torch.float16):
        st["master"] = p.detach().to(torch.float32, copy=True)
    return st


def _read_master(st, p):
    return st["master"] if "master" in st else p.float()


def _write_master(st, new_p32, p):
    if "master" in st:
        st["master"] = new_p32
    return new_p32.to(p.dtype)


class SGD(Optimizer):
    def init_param_state(self, p):
        return _master_init(self, p, {})

    def update_param(self, p, g, st, lr, name):
        st = dict(st)
        new_p32 = _read_master(st, p) - lr * g.float()
        return _write_master(st, new_p32, p), st


class Momentum(Optimizer):
    """``v = momentum * v + g``, ``p -= lr * v`` (with ``use_nesterov``,
    ``p -= lr * (g + momentum * v)``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        if momentum is None:
            raise ValueError("momentum is not set")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_param_state(self, p):
        dt = _acc_dtype(p, self._multi_precision)
        return _master_init(self, p, {
            "velocity": torch.zeros(p.shape, dtype=dt, device=p.device)})

    def update_param(self, p, g, st, lr, name):
        st = dict(st)
        g32 = g.float()
        v = self._momentum * st["velocity"] + g32
        upd = g32 + self._momentum * v if self._nesterov else v
        st["velocity"] = v.to(st["velocity"].dtype)
        new_p32 = _read_master(st, p) - lr * upd
        return _write_master(st, new_p32, p), st


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        for nm, b in (("beta1", beta1), ("beta2", beta2)):
            if not 0 <= b < 1:
                raise ValueError(
                    f"Invalid value of {nm}, expect {nm} in [0, 1).")
        if epsilon < 0:
            raise ValueError("Invalid value of epsilon, expect epsilon >= 0.")
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode (sparse-table rows) is not in the port yet "
                "(ROADMAP.md, port queue item 9: long tail)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def init_param_state(self, p):
        dt = _acc_dtype(p, self._multi_precision)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return _master_init(self, p, {
            "moment1": torch.zeros(p.shape, dtype=dt, device=p.device),
            "moment2": torch.zeros(p.shape, dtype=dt, device=p.device),
            "beta1_pow": one, "beta2_pow": one.clone()})

    def _adam_update(self, g, st, lr):
        """Returns (step, new_state without the master copy)."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g32 = g.float()
        m = b1 * st["moment1"] + (1 - b1) * g32
        v = b2 * st["moment2"] + (1 - b2) * g32 * g32
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        step = lr * mhat / (torch.sqrt(vhat) + eps)
        return step, {"moment1": m.to(st["moment1"].dtype),
                      "moment2": v.to(st["moment2"].dtype),
                      "beta1_pow": b1p, "beta2_pow": b2p}

    def update_param(self, p, g, st, lr, name):
        step, new_st = self._adam_update(g, st, lr)
        if "master" in st:
            new_st["master"] = st["master"]
        new_p32 = _read_master(new_st, p) - step
        return _write_master(new_st, new_p32, p), new_st


class AdamW(Adam):
    """Adam with decoupled weight decay ``p -= lr * coeff * p`` (taken from
    the master copy); ``apply_decay_param_fun(name) -> bool`` picks the
    parameters that decay."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "lr_ratio is not in the port yet (ROADMAP.md, port queue "
                "item 9: long tail)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd_coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def update_param(self, p, g, st, lr, name):
        step, new_st = self._adam_update(g, st, lr)
        if "master" in st:
            new_st["master"] = st["master"]
        decay = self._wd_coeff
        if (self._apply_decay_param_fun is not None and name is not None
                and not self._apply_decay_param_fun(name)):
            decay = 0.0
        p32 = _read_master(new_st, p)
        new_p32 = p32 - lr * decay * p32 - step
        return _write_master(new_st, new_p32, p), new_st
