"""Communication-efficient data-parallel training: LocalSGD, Geo-SGD, DGC
and the compressed all-reduce. Counterpart of
``paddle_tpu/distributed/fleet/comm_efficient.py``.

The JAX package runs each as one compiled program over the mesh's "dp"
axis: a leading replica axis ``[dp, ...]`` mapped by ``vmap`` (LocalSGD,
Geo) or a ``shard_map`` over "dp" (DGC, the compressed all-reduce). Here
each rank is one replica, SPMD over ``torch.distributed``: it holds its
own tensors, takes its ``1/dp`` rows of the global batch
(``_split_batch``), runs the forward and backward on them, and the
collectives of the JAX program are written out on the mesh's dp group:

* ``LocalSGDTrainStep``: each rank updates its own parameters and
  optimizer state, with no gradient collective; every ``k_steps``-th
  step (and every step up to ``begin_step``) the parameters are averaged
  by one all-reduce over dp.
* ``GeoSGDTrainStep``: local steps as LocalSGD; every ``k_steps``-th step
  the geo merge ``base + sum_r(replica_r - base)`` (a SUM of deltas),
  one all-reduce, run only on merge steps.
* ``DGCTrainStep``: momentum-corrected residuals per rank; only each
  rank's top-k entries travel (an all-gather of k indices and k values);
  every rank scatter-adds them into the same averaged sparse gradient and
  applies plain SGD, so the parameters stay replicated.
* ``CompressedAllreduceTrainStep``: the gradient averaged by an
  all-to-all of bf16 (or blockwise int8 + scale) chunks, a local mean of
  this rank's chunk, and an all-gather of it compressed again.

Every step returns the dp mean of the ranks' losses (one scalar
all-reduce, which the JAX program's replica mean is too). Rank r's model
holds replica r (the JAX package reflects replica 0 into its eager
parameters). The blockwise int8 quantizer, the top-k and the scatter-add
are plain PyTorch, as they are ``jnp`` that XLA fuses in the JAX package.
The flat order is ``named_parameters()`` order, padded as the JAX package
pads, so the int8 blocks fall on the same elements.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...framework import attempt
from .. import collective as C
from .. import mesh as mesh_mod
from .placement import place_model

__all__ = ["LocalSGDTrainStep", "DGCTrainStep",
           "CompressedAllreduceTrainStep", "GeoSGDTrainStep"]


def _split_batch(batch, n, i):
    """Block ``i`` of ``n`` along dim 0 of every batch tensor (a scalar
    stays whole): data-parallel rank i's rows."""
    def split(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.dim() == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"dp={n}")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]
    return tuple(split(x) for x in batch)


# shared flatten/unflatten plumbing for the flat-vector exchanges

def _tree_layout(pv):
    shapes = {k: tuple(v.shape) for k, v in pv.items()}
    sizes = {k: int(np.prod(v.shape)) or 1 for k, v in pv.items()}
    return list(pv), shapes, sizes


def _flatten_by(tree, order, pad=0):
    parts = [tree[k].float().reshape(-1) for k in order]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _unflatten_by(flat, order, shapes, sizes):
    out, off = {}, 0
    for k in order:
        n = sizes[k]
        out[k] = flat[off:off + n].reshape(shapes[k])
        off += n
    return out


def _quant_blocks(x, nblk):
    """Blockwise int8: x ``[..., chunk]`` -> (int8 ``[..., chunk]``, fp32
    scales ``[..., nblk]``): scale = max|x| / 127 of each block (at least
    1e-30), round half to even, clip to +-127. The 127 is a tensor on x's
    device: CUDA divides by a host scalar as a multiply by its reciprocal,
    which is not the division the CPU and XLA round."""
    xb = x.reshape(*x.shape[:-1], nblk, -1)
    s = xb.abs().amax(dim=-1, keepdim=True) / torch.tensor(
        127.0, device=x.device)
    s = torch.clamp_min(s, 1e-30)
    q = torch.round(xb / s).clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape), s[..., 0]


def _dequant_blocks(q, s, nblk):
    qb = q.float().reshape(*q.shape[:-1], nblk, -1)
    return (qb * s[..., None]).reshape(q.shape)


def _top_k(x, k):
    """Indices of the ``k`` largest entries of ``x``."""
    return torch.topk(x, k).indices


class _ReplicaStep:
    """What the data-parallel steps share: the mesh's dp group, this
    rank's rows of the batch, one forward and backward on them, the dp
    mean of the loss."""

    def _init_replica(self, model, loss_fn):
        self.model = model
        self.loss_fn = loss_fn
        self.mesh = mesh = mesh_mod.get_mesh()
        self.dp = mesh.axis_size("dp")
        self._dp_group = mesh.group("dp")
        self._dp_index = mesh.axis_index("dp")
        place_model(model, mesh, 0, whole=True)
        self._params = dict(model.named_parameters())
        self._views = {k: p.detach() for k, p in self._params.items()}

    def _grads(self, batch):
        """(loss, {name: grad}) on this rank's rows; a parameter the loss
        does not reach gets a zero gradient, as jax.grad gives it."""
        batch = _split_batch(batch, self.dp, self._dp_index)
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch).float()
        attempt.check()             # an abandoned attempt stops here
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self._params.items()}
        for p in self._params.values():
            p.grad = None
        return loss.detach(), grads

    def _dp_mean(self, loss):
        if self.dp == 1:
            return loss
        return C.all_reduce(loss.clone(), group=self._dp_group) / self.dp

    @staticmethod
    def _sched_step(optimizer):
        sched = optimizer._lr_scheduler() if optimizer is not None else None
        if sched is not None:
            sched.step()

    def replicas(self) -> dict:
        """Every rank's parameters stacked in dp order: name -> ``[dp,
        ...]`` (the JAX step's ``_param_vals`` layout). Every rank of the
        dp group calls it."""
        return {k: C.all_gather(None, p.detach(), group=self._dp_group)
                for k, p in self._params.items()}


class LocalSGDTrainStep(_ReplicaStep):
    """LocalSGD step. ``k_steps=1`` is exact synchronous DP (average
    every step); larger k trades staleness for k-fold fewer parameter
    synchronizations. ``syncs`` counts the averaging all-reduces run."""

    def __init__(self, model, optimizer, loss_fn: Callable, k_steps=4,
                 begin_step=1, strategy=None):
        self._init_replica(model, loss_fn)
        self.optimizer = optimizer
        self.k_steps = max(1, int(k_steps))
        # reference localsgd_optimizer begin_step: fully synchronous
        # (average every step) until this step count, then go local
        self.begin_step = max(0, int(begin_step))
        self._state = optimizer.init_state(self._views)
        self._count = 0
        self.syncs = 0

    def _average(self):
        """Each parameter replaced by its mean over dp (in fp32)."""
        with torch.no_grad():
            for p in self._views.values():
                t = C.all_reduce(p.float(), group=self._dp_group)
                p.copy_(t / self.dp)
        self.syncs += 1

    def __call__(self, *batch):
        loss, grads = self._grads(batch)
        self.optimizer.apply_in_place(self._views, grads, self._state,
                                      self.optimizer.get_lr())
        del grads
        self._count += 1
        if (self._count % self.k_steps == 0
                or self._count <= self.begin_step):
            self._average()
        self._sched_step(self.optimizer)
        return self._dp_mean(loss)


class GeoSGDTrainStep(_ReplicaStep):
    """Geo-SGD (``DistributedStrategy.a_sync`` with ``a_sync_configs
    ["k_steps"]`` > 0): local updates as LocalSGD, and every k-th step the
    geo merge ``merged = base + sum_r(replica_r - base)``, ``base <-
    merged``: the SUM of the replicas' deltas, as the geo parameter server
    applies it. The merge's all-reduce runs on merge steps only (the JAX
    program's ``lax.cond``); ``merges`` counts them."""

    def __init__(self, model, optimizer, loss_fn: Callable, k_steps=8,
                 strategy=None):
        if int(k_steps) < 1:
            raise NotImplementedError(
                "a_sync with k_steps == 0 is the pure-async PS mode; "
                "a single-controller mesh has no async analog — use "
                "geo (k_steps >= 1) or synchronous training")
        self._init_replica(model, loss_fn)
        self.optimizer = optimizer
        self.k_steps = int(k_steps)
        self._base = {k: v.clone() for k, v in self._views.items()}
        self._state = optimizer.init_state(self._views)
        self._count = 0
        self.merges = 0

    def _delta_sum(self, delta):
        """The replicas' deltas summed over dp (not averaged)."""
        return C.all_reduce(delta, group=self._dp_group)

    def _merge(self):
        with torch.no_grad():
            for k, p in self._views.items():
                b = self._base[k]
                delta = self._delta_sum(p.float() - b.float())
                merged = (b.float() + delta).to(p.dtype)
                p.copy_(merged)
                b.copy_(merged)
        self.merges += 1

    def __call__(self, *batch):
        loss, grads = self._grads(batch)
        self.optimizer.apply_in_place(self._views, grads, self._state,
                                      self.optimizer.get_lr())
        del grads
        self._count += 1
        if self._count % self.k_steps == 0:
            self._merge()
        self._sched_step(self.optimizer)
        return self._dp_mean(loss)

    def replica_divergence(self) -> float:
        """Max abs difference of any parameter from replica 0's, over
        every rank: 0.0 right after a merge step (the geo staleness
        bound's floor). Every rank of the dp group calls it."""
        worst = torch.zeros((), dtype=torch.float32)
        g = self._dp_group
        src = g.ranks[0] if g is not None else 0
        with torch.no_grad():
            for p in self._views.values():
                p0 = C.broadcast(p.clone(), src=src, group=g)
                worst = torch.maximum(
                    worst, (p.float() - p0.float()).abs().max().cpu())
        dev = next(iter(self._views.values())).device
        return float(C.all_reduce(worst.to(dev), C.ReduceOp.MAX, group=g))


class DGCTrainStep(_ReplicaStep):
    """DGC step (``sparsity`` in [0, 1): 0.99 sends the top 1% of the
    momentum-corrected residual entries of each rank each step). The
    update is plain SGD at the optimizer's (scheduled) lr: DGC folds the
    momentum into the residual correction (reference
    ``DGCMomentumOptimizer`` wraps Momentum), so Adam-family optimizers
    are refused."""

    def __init__(self, model, loss_fn: Callable, optimizer=None,
                 learning_rate=0.1, momentum=None, sparsity=0.99,
                 clip_norm=None, strategy=None):
        self._optimizer = optimizer
        if optimizer is not None:
            from ...optimizer.algorithms import SGD, Momentum
            if not isinstance(optimizer, (SGD, Momentum)):
                raise TypeError(
                    f"DGC requires SGD/Momentum, got "
                    f"{type(optimizer).__name__}")
            if momentum is None:
                momentum = getattr(optimizer, "_momentum", 0.0)
        self.momentum = float(0.9 if momentum is None else momentum)
        self.lr = float(learning_rate if optimizer is None
                        else optimizer.get_lr())
        # DGC paper §3.2 local gradient clipping: each rank's gradient
        # norm bounded by clip_norm/sqrt(dp) before accumulation
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        self._init_replica(model, loss_fn)
        pv = self._views
        self._order, self._shapes, self._sizes = _tree_layout(pv)
        self._N = sum(self._sizes.values())
        self.k = max(1, int(round(self._N * (1.0 - float(sparsity)))))
        dev = next(iter(pv.values())).device
        # this rank's residuals
        self._u = torch.zeros(self._N, dtype=torch.float32, device=dev)
        self._v = torch.zeros(self._N, dtype=torch.float32, device=dev)

    def _send(self, u, v):
        """(indices, values) of the top-k ``|v|``, cleared from the
        residuals ``u`` and ``v`` in place."""
        idx = _top_k(v.abs(), self.k)
        vals = v[idx]
        v[idx] = 0.0
        u[idx] = 0.0
        return idx, vals

    def __call__(self, *batch):
        loss, grads = self._grads(batch)
        lr = (self._optimizer.get_lr() if self._optimizer is not None
              else self.lr)
        dp, N = self.dp, self._N
        with torch.no_grad():
            g = _flatten_by(grads, self._order)
            del grads
            if self.clip_norm is not None:
                bound = self.clip_norm / (dp ** 0.5)
                norm = torch.sqrt(torch.sum(g * g))
                g = g * torch.clamp(bound / torch.clamp_min(norm, 1e-12),
                                    max=1.0)
            u = self.momentum * self._u + g           # momentum correction
            v = self._v + u
            idx, vals = self._send(u, v)
            self._u, self._v = u, v
            # 2k words instead of N: gather every rank's selection
            gidx = C.all_gather(None, idx, group=self._dp_group)
            gval = C.all_gather(None, vals, group=self._dp_group)
            g_comb = torch.zeros(N, dtype=torch.float32, device=g.device)
            g_comb.index_add_(0, gidx.reshape(-1), gval.reshape(-1))
            g_comb = g_comb / dp
            g_tree = _unflatten_by(g_comb, self._order, self._shapes,
                                   self._sizes)
            for k, p in self._views.items():
                p.copy_((p.float() - lr * g_tree[k]).to(p.dtype))
        self._sched_step(self._optimizer)
        return self._dp_mean(loss)


class CompressedAllreduceTrainStep(_ReplicaStep):
    """Data-parallel step whose gradient all-reduce runs compressed
    (reference ``fp16_allreduce_optimizer.py``). Both modes are one
    reduce-scatter (an all-to-all of per-destination chunks) + a local
    mean + an all-gather, with the wire payload compressed:

    * ``dtype="bfloat16"``: chunks travel as bf16;
    * ``dtype="int8"``: blockwise int8 (one scale per ``_QBLOCK``
      elements), dequantized, averaged and re-quantized for the
      all-gather.

    The optimizer is unrestricted: the averaged gradients reach it in
    full precision."""

    _QBLOCK = 1024  # int8 quantization block (elements per scale)

    def __init__(self, model, optimizer, loss_fn: Callable,
                 dtype="bfloat16", strategy=None):
        if dtype not in ("bfloat16", "int8"):
            raise ValueError(f"unsupported compression dtype {dtype!r}")
        self._init_replica(model, loss_fn)
        self.optimizer = optimizer
        self.dtype = dtype
        pv = self._views
        self._order, self._shapes, self._sizes = _tree_layout(pv)
        n = sum(self._sizes.values())
        self._N = n
        # int8 needs whole quantization blocks per chunk; bf16 only needs
        # dp-divisibility
        self._pad = (-n) % (self.dp * self._QBLOCK if dtype == "int8"
                            else self.dp)
        self.chunk = (n + self._pad) // self.dp
        self.nblk = max(1, self.chunk // self._QBLOCK)
        self._state = optimizer.init_state(pv)

    def _average(self, g):
        """Flat local gradient ``[n_pad]`` -> the dp mean, decompressed,
        on every rank."""
        dp, grp, nblk = self.dp, self._dp_group, self.nblk
        # [dp, chunk]: row d is the chunk for rank d; after the all-to-all
        # row j is this rank's chunk as rank j computed it
        gc = g.reshape(dp, self.chunk)
        if self.dtype == "bfloat16":
            q1t = C.alltoall_single(gc.to(torch.bfloat16), group=grp)
            mine = q1t.float().mean(dim=0)
            q2g = C.all_gather(None, mine.to(torch.bfloat16), group=grp)
            return q2g.float().reshape(-1)
        q1, s1 = _quant_blocks(gc, nblk)
        q1t = C.alltoall_single(q1, group=grp)
        s1t = C.alltoall_single(s1, group=grp)
        mine = _dequant_blocks(q1t, s1t, nblk).mean(dim=0)
        q2, s2 = _quant_blocks(mine, nblk)
        q2g = C.all_gather(None, q2, group=grp)           # [dp, chunk]
        s2g = C.all_gather(None, s2, group=grp)           # [dp, nblk]
        return _dequant_blocks(q2g, s2g, nblk).reshape(-1)

    def __call__(self, *batch):
        loss, grads = self._grads(batch)
        with torch.no_grad():
            g = _flatten_by(grads, self._order, self._pad)
            del grads
            g_avg = self._average(g)
            del g
            g_tree = _unflatten_by(g_avg, self._order, self._shapes,
                                   self._sizes)
            grads = {k: g_tree[k].to(p.dtype) for k, p in self._views.items()}
        self.optimizer.apply_in_place(self._views, grads, self._state,
                                      self.optimizer.get_lr())
        self._sched_step(self.optimizer)
        return self._dp_mean(loss)
