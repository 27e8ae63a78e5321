"""The world-size-1 train step. Counterpart of
``paddle_tpu/distributed/fleet/train_step.py`` (``CompiledTrainStep``,
``make_train_step``).

Each call runs what the JAX package compiles into one program, eagerly:
drop the old gradients, run ``loss_fn(model, *batch)`` and its backward,
clip, update every parameter through the optimizer (written in place
one parameter at a time; see ``Optimizer.apply_in_place``), then step
the LR scheduler. It returns the loss as a detached fp32 scalar.

``accumulate_steps=k`` (or ``strategy.gradient_merge``) splits every
batch tensor along its first dim into k micro-batches, sums their
gradients in fp32, applies one update with the mean, and returns the
mean of the micro losses; with equal micro-batches that is the
full-batch step. Loss scaling (``scaler=``) and ``amp_level=`` come with
the amp slice and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["TrainStep", "make_train_step"]

_AMP = ("amp and loss scaling are not in the port yet (ROADMAP.md, port "
        "queue item 10: amp and attention dropout)")


class TrainStep:
    """Callable train step bound to ``(model, optimizer, loss_fn)``;
    ``loss_fn(model, *batch)`` returns a scalar loss tensor."""

    def __init__(self, model, optimizer, loss_fn: Callable, strategy=None,
                 accumulate_steps: Optional[int] = None, amp_level=None,
                 scaler=None):
        if amp_level or scaler is not None:
            raise NotImplementedError(_AMP)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy
        if accumulate_steps is None:
            accumulate_steps = 1
            if strategy is not None and strategy.gradient_merge:
                accumulate_steps = int(
                    strategy.gradient_merge_configs.get("k_steps", 1))
        self.accumulate_steps = max(1, int(accumulate_steps))
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._views = {k: p.detach() for k, p in self._params.items()}
        self._state = optimizer.init_state(self._views)

    def _loss(self, batch):
        return self.loss_fn(self.model, *batch).float()

    def _micro_batches(self, batch):
        k = self.accumulate_steps
        for x in batch:
            if x.dim() and x.shape[0] % k:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                 f"accumulate_steps {k}")
        parts = [x.chunk(k, dim=0) if x.dim() else (x,) * k for x in batch]
        return list(zip(*parts))

    def _grads(self, batch):
        """(loss, {name: grad}) over the batch: one backward, or k with
        fp32 accumulation. A parameter the loss does not reach gets a
        zero gradient, as jax.grad gives it."""
        if self.accumulate_steps == 1:
            loss = self._loss(batch)
            loss.backward()
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in self._params.items()}
            return loss.detach(), grads
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in self._params.items()}
        losses = []
        for mb in self._micro_batches(batch):
            loss = self._loss(mb)
            loss.backward()
            for k, p in self._params.items():
                if p.grad is not None:
                    acc[k] += p.grad.float()
                    p.grad = None
            losses.append(loss.detach())
        n = self.accumulate_steps
        grads = {k: (a / n).to(self._params[k].dtype) for k, a in acc.items()}
        return torch.stack(losses).mean(), grads

    def __call__(self, *batch):
        batch = tuple(x if isinstance(x, torch.Tensor)
                      else torch.as_tensor(np.asarray(x)) for x in batch)
        for p in self._params.values():
            p.grad = None
        loss, grads = self._grads(batch)
        self.optimizer.apply_in_place(self._views, grads, self._state,
                                      self.optimizer.get_lr())
        del grads
        for p in self._params.values():
            p.grad = None
        sched = self.optimizer._lr_scheduler()
        if sched is not None:
            sched.step()
        return loss

    # -- snapshot surface ---------------------------------------------------
    def state_dict(self):
        """The step's parameters and optimizer state (tensors, not
        copies)."""
        return {"params": dict(self._views), "opt": self._state}

    def load_state_dict(self, state):
        """Copy a ``state_dict()`` into this step's parameters (in their
        dtypes) and optimizer state, on the parameters' devices."""
        with torch.no_grad():
            for k, v in self._views.items():
                v.copy_(state["params"][k])
        self._state = {
            k: {n: t.detach().to(self._views[k].device, copy=True)
                for n, t in state["opt"][k].items()}
            for k in self._views}


def make_train_step(model, optimizer, loss_fn, strategy=None,
                    accumulate_steps=None, amp_level=None,
                    scaler=None) -> TrainStep:
    return TrainStep(model, optimizer, loss_fn, strategy,
                     accumulate_steps, amp_level, scaler)
