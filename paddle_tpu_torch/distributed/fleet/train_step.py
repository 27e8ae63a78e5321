"""The hybrid-parallel train step. Counterpart of
``paddle_tpu/distributed/fleet/train_step.py`` (``CompiledTrainStep``,
``make_train_step``).

Each call runs, eagerly and with the collectives written out, what the
JAX package compiles into one GSPMD program. The caller passes the
global batch; on the mesh of ``fleet.init`` (``distributed.mesh``):

1. each rank takes its ``data_pspec`` slice of every batch tensor (the
   batch dim over ``(dp, sharding)``, whole when it does not divide; the
   sequence dim over ``sep``, which it must divide);
2. ``loss_fn(model, *batch)`` and its backward run on the slice. Under
   tensor parallel the ``mp_layers`` do their collectives; at stage 3
   the sharded parameters are gathered per unit and their gradients
   reduce-scattered over the sharding group (``placement.Stage3``);
   under sequence parallel both run inside ``mesh.sequence_shard``, so
   the model attends over the ring and returns its part of the global
   loss (the parts of the ``(dp, sep)`` ranks sum to it), and a remat
   layer's recompute (collectives included) runs to its end;
3. gradients are averaged over ``(dp, sharding)``; under sequence
   parallel (sharding and tp are 1 there) they are summed over
   ``(dp, sep)``, one all-reduce, as the losses are. Where the
   optimizer
   state is sharded beyond the parameter (``opt_state_pspec``: stages 1
   and 2, and stage 3's tp parameters), this rank keeps its block: at
   stage 1 by an all-reduce and a slice, at stages 2 and 3 by a
   reduce-scatter over the sharding group and an all-reduce over dp;
4. clip (norms over the full gradients), then the optimizer updates this
   rank's blocks in place one parameter at a time (``Optimizer
   .apply_in_place``: moments, master copies, decay per block), and
   blocks narrower than their parameter are all-gathered back into it;
5. the LR scheduler steps. The loss returned is the global mean, a
   detached fp32 scalar.

On a mesh with sep > 1 the model must run sequence-parallel attention
(``placement.place_model`` asks it), as ``LlamaConfig(sequence_parallel
=True)`` does; any other model is refused here.

On a mesh of one rank every collective is the identity and the step is
the single-GPU step exactly. ``accumulate_steps=k`` (or
``strategy.gradient_merge``) splits this rank's slice into k
micro-batches, sums their gradients in fp32, and applies one update with
the mean; with equal micro-batches that is the full-batch step.

Mixed precision, as the JAX step compiles it: with ``amp_level`` ("O1",
"O2") the loss runs under ``amp.auto_cast(level=, dtype=amp_dtype)``.
With a ``scaler`` (an enabled ``amp.GradScaler``, whose configuration is
read once) the backward runs on ``loss.float() * scale``, the (reduced)
gradients are divided by ``scale`` in their own dtype, and ``found_inf``
(any gradient non-finite on any rank: a MAX all-reduce over the world,
since a rank may hold only its block of a gradient) is read on the host
once: when set, the update is skipped, so the parameters and the whole
optimizer state stay bit for bit as they were (JAX's ``where(found_inf,
old, new)`` without a copy of the state); the LR scheduler still steps.
The scale and its good/bad counters follow ``_next_scaler_state`` on the
device; ``last_found_inf`` and ``state_dict()["scaler"]`` expose them.

Snapshots: ``state_dict()`` gives this rank's live tensors (the model's
buffers among them, as the JAX step carries them) and
``load_state_dict`` copies a snapshot of this rank's layout in; a
snapshot of another layout (other ranks, another sharding or tp layout)
raises ``NotImplementedError`` (ROADMAP.md, port queue item 7). A step
abandoned by its supervisor (``framework.attempt``) refuses to start its
backward and drops its in-place writes.

The collectives are explicit, driven by the ported placement rules,
rather than FSDP2's: FSDP2 shards dim 0 of every parameter, and the JAX
rule shards the largest divisible dim and leaves tp and small
parameters whole.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from ...amp.auto_cast import auto_cast
from ...framework import attempt
from ...optimizer.optimizer import lr_scales
from .. import mesh as mesh_mod
from ..collective import ReduceOp, all_reduce, gather_dim, reduce_scatter_dim
from .placement import place_model, placement, saving

__all__ = ["TrainStep", "make_train_step"]


def _opt_dim(pspec, ospec):
    """The dim where the optimizer state's spec adds "sharding" to the
    parameter's, or None."""
    for d, (p, o) in enumerate(zip(pspec, ospec)):
        if o == "sharding" and p != "sharding":
            return d
    return None


class TrainStep:
    """Callable train step bound to ``(model, optimizer, loss_fn)``;
    ``loss_fn(model, *batch)`` returns a scalar loss tensor."""

    def __init__(self, model, optimizer, loss_fn: Callable, strategy=None,
                 accumulate_steps: Optional[int] = None, amp_level=None,
                 scaler=None, amp_dtype="bfloat16"):
        if strategy is not None:
            strategy.check()
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy
        self.stage = strategy.sharding_stage if strategy is not None else 0
        if accumulate_steps is None:
            accumulate_steps = 1
            if strategy is not None:
                if strategy.gradient_merge:
                    accumulate_steps = int(
                        strategy.gradient_merge_configs.get("k_steps", 1))
                elif strategy.pipeline:
                    accumulate_steps = int(
                        strategy.pipeline_configs.get("accumulate_steps", 1))
        self.accumulate_steps = max(1, int(accumulate_steps))
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.mesh = m = mesh_mod.get_mesh()
        place_model(model, m, self.stage)
        self._params = {k: p for k, p in model.named_parameters()
                        if p.requires_grad}
        self._lr_scale = lr_scales(self._params)
        self._buffers = dict(model.named_buffers())
        self._pspec = {k: placement(p) for k, p in self._params.items()}
        self._ospec = {k: mesh_mod.opt_state_pspec(
            self._pspec[k], p.full_shape, p.full_shape, self.stage, mesh=m)
            for k, p in self._params.items()}
        self._odim = {k: _opt_dim(self._pspec[k], self._ospec[k])
                      for k in self._params}
        # this rank's parameter blocks, and the blocks its optimizer
        # state covers (narrower where the state is sharded further)
        self._locals = {k: p.detach() for k, p in self._params.items()}
        self._views = {k: self._narrow(t, self._odim[k])
                       for k, t in self._locals.items()}
        self._state = optimizer.init_state(self._views)
        self._data = m.group(("dp", "sharding"))
        # sequence parallel: gradients and the loss sum over (dp, sep)
        self._sep = (m.group(("dp", "sep")) if m.axis_size("sep") > 1
                     else None)
        # dynamic loss scaling: the scaler's configuration, read as the
        # JAX step reads it
        self._scaler_cfg = None
        if scaler is not None and getattr(scaler, "_enable", True):
            self._scaler_cfg = {
                "init": float(getattr(scaler, "_scale", 2.0 ** 15)),
                "incr_ratio": float(getattr(scaler, "_incr_ratio", 2.0)),
                "decr_ratio": float(getattr(scaler, "_decr_ratio", 0.5)),
                "incr_every": int(getattr(scaler, "_incr_every", 1000)),
                "decr_every": int(getattr(scaler, "_decr_every", 1)),
                "dynamic": bool(getattr(scaler, "_dynamic", True)),
            }
        dev = next(iter(self._locals.values())).device if self._locals \
            else torch.device("cpu")
        self._scaler_state = {
            "scale": torch.tensor(self._scaler_cfg["init"]
                                  if self._scaler_cfg else 1.0,
                                  dtype=torch.float32, device=dev),
            "good": torch.zeros((), dtype=torch.int32, device=dev),
            "bad": torch.zeros((), dtype=torch.int32, device=dev)}
        self.last_found_inf = torch.zeros((), dtype=torch.bool, device=dev)

    def _narrow(self, t, d):
        if d is None:
            return t
        k = t.shape[d] // self.mesh.axis_size("sharding")
        return t.narrow(d, self.mesh.axis_index("sharding") * k, k)

    def _local_batch(self, x):
        n = self.mesh.axis_size("sep")
        if n > 1 and x.dim() >= 2 and x.shape[1] % n:
            raise ValueError(f"seq len {x.shape[1]} not divisible by {n}")
        spec = mesh_mod.data_pspec(x.shape, self.mesh)
        return mesh_mod.local_block(x, spec, self.mesh) if any(spec) else x

    def _sequence_shard(self):
        """The sequence-shard context of a sep mesh: the model's inputs
        are this rank's shard, and remat recomputes whole layers (their
        collectives in the same order on every rank)."""
        if self._sep is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(mesh_mod.sequence_shard(self.mesh))
        stack.enter_context(set_checkpoint_early_stop(False))
        return stack

    def _loss(self, batch):
        amp = (auto_cast(True, level=self.amp_level, dtype=self.amp_dtype)
               if self.amp_level else contextlib.nullcontext())
        with saving(self.model), amp:
            return self.loss_fn(self.model, *batch).float()

    def _backward(self, loss):
        attempt.check()
        if self._scaler_cfg:
            loss = loss * self._scaler_state["scale"]
        loss.backward()

    def _micro_batches(self, batch):
        k = self.accumulate_steps
        for x in batch:
            if x.dim() and x.shape[0] % k:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                 f"accumulate_steps {k}")
        parts = [x.chunk(k, dim=0) if x.dim() else (x,) * k for x in batch]
        return list(zip(*parts))

    def _grads(self, batch):
        """(loss, {name: grad}) over this rank's batch: one backward, or k
        with fp32 accumulation. A parameter the loss does not reach gets
        a zero gradient, as jax.grad gives it."""
        if self.accumulate_steps == 1:
            with self._sequence_shard():
                loss = self._loss(batch)
                self._backward(loss)
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in self._params.items()}
            return loss.detach(), grads
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in self._params.items()}
        losses = []
        for mb in self._micro_batches(batch):
            with self._sequence_shard():
                loss = self._loss(mb)
                self._backward(loss)
            for k, p in self._params.items():
                if p.grad is not None:
                    acc[k] += p.grad.float()
                    p.grad = None
            losses.append(loss.detach())
        n = self.accumulate_steps
        grads = {k: (a / n).to(self._params[k].dtype) for k, a in acc.items()}
        return torch.stack(losses).mean(), grads

    def _reduce(self, k, g):
        """This rank's block of the gradient averaged over (dp,
        sharding), as the optimizer state of ``k`` covers it; under
        sequence parallel summed over (dp, sep)."""
        m, d = self.mesh, self._odim[k]
        n = self._data.nranks
        if self._sep is not None:
            return all_reduce(g, group=self._sep)
        if n == 1:
            return g
        if "sharding" in self._pspec[k]:
            # stage 3: the backward reduce-scattered it over sharding
            g = all_reduce(g, group=m.group("dp"))
        elif d is not None and self.stage >= 2:
            g = reduce_scatter_dim(g, d, m.group("sharding"))
            g = all_reduce(g, group=m.group("dp"))
        else:
            g = self._narrow(all_reduce(g, group=self._data), d)
        return g / n

    def _unscale(self, grads):
        """Divide the gradients by the scale (in their dtypes); return
        the world's ``found_inf`` as a device bool."""
        scale = self._scaler_state["scale"]
        bad = torch.zeros((), dtype=torch.float32,
                          device=scale.device)
        for g in grads.values():
            g.div_(scale.to(g.dtype))
            bad = torch.maximum(bad, (~torch.isfinite(g)).any().float())
        if self.mesh.size > 1:
            bad = all_reduce(bad, ReduceOp.MAX)
        return bad > 0

    def _next_scaler_state(self, st, found_inf):
        cfg = self._scaler_cfg
        if not cfg["dynamic"]:
            return st
        scale, good, bad = st["scale"], st["good"], st["bad"]
        zero = torch.zeros_like(good)
        bad2 = torch.where(found_inf, bad + 1, zero)
        good2 = torch.where(found_inf, zero, good + 1)
        shrink = bad2 >= cfg["decr_every"]
        grow = good2 >= cfg["incr_every"]
        new_scale = torch.where(
            shrink, torch.clamp_min(scale * cfg["decr_ratio"], 1.0),
            torch.where(grow, scale * cfg["incr_ratio"], scale))
        return {"scale": new_scale.float(),
                "good": torch.where(grow, zero, good2),
                "bad": torch.where(shrink, zero, bad2)}

    def __call__(self, *batch):
        attempt.check()
        batch = tuple(
            self._local_batch(x if isinstance(x, torch.Tensor)
                              else torch.as_tensor(np.asarray(x)))
            for x in batch)
        for p in self._params.values():
            p.grad = None
        loss, grads = self._grads(batch)
        grads = {k: self._reduce(k, g) for k, g in grads.items()}
        if self._sep is not None:
            loss = all_reduce(loss.clone(), group=self._sep)
        elif self._data.nranks > 1:
            loss = all_reduce(loss.clone(), group=self._data) \
                / self._data.nranks
        skip, scaler_state = False, None
        if self._scaler_cfg:
            found = self._unscale(grads)
            scaler_state = self._next_scaler_state(self._scaler_state, found)
            skip = bool(found)          # the step's one host read
        with attempt.commit():
            if scaler_state is not None:
                self.last_found_inf = found
                self._scaler_state = scaler_state
            if not skip:
                self.optimizer.apply_in_place(
                    self._views, grads, self._state, self.optimizer.get_lr(),
                    specs=self._ospec if self.mesh.size > 1 else None,
                    lr_scale=self._lr_scale)
            del grads
            for k, d in self._odim.items():
                if d is not None and not skip:
                    self._locals[k].copy_(gather_dim(
                        self._views[k], d, self.mesh.group("sharding")))
            for p in self._params.values():
                p.grad = None
            sched = self.optimizer._lr_scheduler()
            if sched is not None:
                sched.step()
        return loss

    # -- snapshot surface ---------------------------------------------------
    def state_dict(self):
        """This rank's parameter blocks, optimizer state, the model's
        buffers (BatchNorm's running statistics, QAT's observers) and the
        loss-scaler state (tensors, not copies)."""
        return {"params": dict(self._locals), "opt": self._state,
                "buffers": {k: b.detach() for k, b in self._buffers.items()},
                "scaler": self._scaler_state}

    def load_state_dict(self, state):
        """Copy a ``state_dict()`` of this rank into this step's
        parameters and buffers (in place, in their dtypes, on their
        devices) and optimizer state. A snapshot of another layout
        raises."""
        if isinstance(state, (list, tuple)):
            raise NotImplementedError(
                f"restoring a train step written by {len(state)} ranks "
                f"onto {self.mesh.size}: a TrainStep restores only onto "
                "its own layout (ROADMAP.md, port queue item 7)")
        for k, v in self._locals.items():
            got = tuple(np.shape(state["params"][k]))
            if got != tuple(v.shape):
                raise NotImplementedError(
                    f"{k}: a snapshot block of shape {got} onto this "
                    f"rank's {tuple(v.shape)}: restoring onto another "
                    "sharding or tp layout is not in the port (ROADMAP.md, "
                    "port queue item 7)")
        with torch.no_grad():
            for k, v in self._locals.items():
                v.copy_(state["params"][k])
            for k, b in self._buffers.items():
                if k in state.get("buffers", {}):
                    b.copy_(torch.as_tensor(state["buffers"][k]))
        self._state = {
            k: {n: t.detach().to(self._views[k].device, copy=True)
                for n, t in state["opt"][k].items()}
            for k in self._views}
        if "scaler" in state:
            self._scaler_state = {
                k: torch.as_tensor(state["scaler"][k]).to(
                    self._scaler_state[k].device, self._scaler_state[k].dtype,
                    copy=True) for k in self._scaler_state}


def make_train_step(model, optimizer, loss_fn, strategy=None,
                    accumulate_steps=None, amp_level=None, scaler=None,
                    amp_dtype="bfloat16") -> TrainStep:
    return TrainStep(model, optimizer, loss_fn, strategy,
                     accumulate_steps, amp_level, scaler, amp_dtype)
