"""Optimizer base. Counterpart of ``paddle_tpu/optimizer/optimizer.py``.

Two ways in, one update:

* **eager** (paddle-style): ``opt.step()`` consumes ``param.grad`` set by
  ``loss.backward()`` and updates the parameters in place;
  ``clear_grad()`` drops the gradients.
* **functional** (the train step): ``init_state(params)`` and
  ``apply_gradients_functional(params, grads, state, lr)`` over
  ``{name: tensor}`` dicts return new parameters and state, as the JAX
  package's pure functions do.

Both run ``_updates``: clip, coupled L2 decay, then each algorithm's
pure ``update_param(p, g, state, lr, name)`` one parameter at a time. The
eager step and the train step write each result into the parameter and
its state in place as soon as it is computed, so an update never holds a
second copy of all parameters or moments (the JAX package donates its
buffers to the same end).

``name`` is the parameter's structured name (its ``named_parameters``
key in the train step; ``param_<i>`` for the i-th of a plain parameter
list, or the name of a ``(name, param)`` pair), which is what
``AdamW(apply_decay_param_fun=)`` is given. Parameter groups, L1 decay
and the eager fused step are in the port's long tail.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import attempt
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    _decoupled = False      # AdamW decays in update_param, not via grads

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if learning_rate is None:
            raise ValueError("learning_rate is not set")
        if isinstance(learning_rate, torch.Tensor):
            raise TypeError("learning_rate should be a float or an "
                            "LRScheduler, got a Tensor")
        self._params = None
        if parameters is not None:
            self._params = {}
            for i, p in enumerate(parameters):
                if isinstance(p, dict):
                    raise NotImplementedError(
                        "parameter groups are not in the port yet "
                        "(ROADMAP.md, port queue item 9: long tail)")
                key, p = p if isinstance(p, tuple) else (f"param_{i}", p)
                self._params[key] = p
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "weight_decay takes a float (L2) in the port; regularizer "
                "objects are in the long tail (ROADMAP.md, port queue "
                "item 9)")
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._name = name
        self._multi_precision = multi_precision
        self._l2_coeff = float(weight_decay or 0.0)
        self._state: dict = {}

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if not isinstance(value, (int, float)):
            raise TypeError(f"set_lr expects a python float/int, got "
                            f"{type(value).__name__}")
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _lr_scheduler(self):
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    # -- the update, shared by both ways in --------------------------------
    def _updates(self, params: dict, grads: dict, state: dict, lr,
                 specs=None):
        """Yield ``(name, new_param, new_state)`` one parameter at a
        time, after the clip and the coupled L2 decay. A missing state is
        initialised. Under hybrid parallelism ``params``, ``grads`` and
        ``state`` are this rank's blocks (the update is elementwise) and
        ``specs`` their placements, which the clip's norms read."""
        if self._grad_clip is not None:
            grads = self._grad_clip.apply_functional(grads, specs)
        for k, p in params.items():
            g = grads[k]
            if self._l2_coeff and not self._decoupled:
                # JAX multiplies by the coefficient rounded to p's dtype
                coeff = torch.tensor(self._l2_coeff, dtype=p.dtype,
                                     device=p.device)
                g = g + coeff * p
            st = state.get(k)
            if st is None:
                st = self.init_param_state(p)
            new_p, new_st = self.update_param(p, g, st, lr, k)
            yield k, new_p, new_st

    def apply_in_place(self, params: dict, grads: dict, state: dict, lr,
                       specs=None):
        """Run the update and write each new parameter into ``params[k]``
        and its new state into ``state[k]`` before the next one. A step
        attempt abandoned by its supervisor writes nothing
        (``framework.attempt``)."""
        with torch.no_grad(), attempt.commit():
            for k, new_p, new_st in self._updates(params, grads, state, lr,
                                                  specs):
                params[k].copy_(new_p)
                state[k] = new_st

    # -- eager path ----------------------------------------------------------
    def _all_params(self) -> dict:
        if self._params is None:
            raise ValueError("optimizer created without a parameter list")
        return self._params

    def step(self):
        """Apply ``param.grad`` in place. An attempt abandoned by its
        supervisor is refused here, after its backward: the gradient it
        left in ``param.grad`` is cleared by the supervisor before its
        next attempt (``resilience.Supervisor``)."""
        attempt.check()
        live = {k: p for k, p in self._all_params().items()
                if p.grad is not None and p.requires_grad}
        self.apply_in_place({k: p.detach() for k, p in live.items()},
                            {k: p.grad for k, p in live.items()},
                            self._state, self.get_lr())

    def clear_grad(self, set_to_zero=True):
        for p in self._all_params().values():
            p.grad = None

    clear_gradients = clear_grad

    # -- functional path -----------------------------------------------------
    def init_state(self, params: dict) -> dict:
        """params: name -> tensor. Returns name -> state dict."""
        return {k: self.init_param_state(v) for k, v in params.items()}

    def apply_gradients_functional(self, params: dict, grads: dict,
                                   state: dict, lr):
        """Pure update: returns ``(new_params, new_state)`` dicts."""
        new_p, new_s = {}, {}
        for k, p, st in self._updates(params, grads, state, lr):
            new_p[k], new_s[k] = p, st
        return new_p, new_s

    # -- per-algorithm hooks (override) --------------------------------------
    def init_param_state(self, p) -> dict:
        return {}

    def update_param(self, p, g, state: dict, lr, name):
        raise NotImplementedError

    # -- serialization -------------------------------------------------------
    def state_dict(self):
        """The LR (or its scheduler's state) and each parameter's state
        by name: the live tensors, not copies."""
        sched = self._lr_scheduler()
        out = {"_lr": None if sched is not None else self._learning_rate}
        if sched is not None:
            out["_lr_scheduler"] = sched.state_dict()
        for k, st in self._state.items():
            out[k] = dict(st)
        return out

    def set_state_dict(self, state):
        """Load a ``state_dict()``: each state tensor is copied onto its
        parameter's device (the given tensors are never kept, so a
        snapshot restores any number of times)."""
        sched = self._lr_scheduler()
        if sched is not None and "_lr_scheduler" in state:
            sched.set_state_dict(state["_lr_scheduler"])
        for k, p in self._all_params().items():
            if k in state:
                self._state[k] = {
                    n: (torch.as_tensor(v).detach().to(p.device, copy=True)
                        if isinstance(v, (torch.Tensor, np.ndarray)) else v)
                    for n, v in state[k].items()}

    load_state_dict = set_state_dict
