"""Fleet: the hybrid-parallel training API. Counterpart of
``paddle_tpu/distributed/fleet/__init__.py``:

    fleet.init(is_collective=True, strategy=strategy)   # dp/mp/sharding
    model = fleet.distributed_model(LlamaForCausalLM(cfg))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, ids, lbl: m(ids, labels=lbl))
    loss = step(ids, labels)              # the global batch, on every rank

``strategy.amp`` trains through that step under ``amp_level="O1"``
(an explicit ``amp_level=`` wins), with the loss scaling of a
``scaler=`` (``amp.GradScaler``; ``distributed_scaler`` returns it as
given: the step agrees ``found_inf`` over every rank).

The comm-efficient data-parallel strategies pick their own step, as the
JAX package's ``make_train_step`` routes them (one at a time, not with
``amp``, no extra options): ``comm_opt`` -> ``distributed.comm_opt.
CommOptTrainStep``; ``a_sync`` -> ``comm_efficient.GeoSGDTrainStep``;
``localsgd`` -> ``LocalSGDTrainStep``; ``dgc`` -> ``DGCTrainStep``;
``fp16_allreduce`` -> ``CompressedAllreduceTrainStep``. Under them
``distributed_model`` keeps the model whole on every rank
(``place_model(..., whole=True)``).

Pipeline parallel (``pp_degree``) trains ``LlamaForCausalLMPipe``
through that same step (GPipe: the model's forward runs
``ops.pipeline.spmd_pipeline`` and autograd gives the backward) or
through ``make_1f1b_train_step(model, optimizer, n_micro)`` (1F1B).

``init`` joins the process group a launcher's environment describes
(``spawn``, torchrun), builds the strategy's mesh and its process groups
(every rank of the world calls it), and records the strategy.
``distributed_model`` places the model on the mesh
(``placement.place_model``: tp layers split, pp chunks kept, stage-3
parameters sharded); ``distributed_optimizer`` wraps the optimizer with
``make_train_step``. Without a launcher's environment the world is this
one process.
"""
from __future__ import annotations

from typing import Optional

from .. import collective
from . import comm_efficient as ce
from .base import DistributedStrategy, HybridCommunicateGroup
from .meta_optimizers import HybridParallelGradScaler
from .placement import place_model
from .pp_train_step import Pipeline1F1BTrainStep, make_1f1b_train_step
from .train_step import TrainStep, make_train_step
from . import meta_parallel  # noqa: F401

__all__ = ["DistributedStrategy", "HybridCommunicateGroup", "TrainStep",
           "make_train_step", "Pipeline1F1BTrainStep",
           "make_1f1b_train_step", "init", "get_strategy",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "distributed_scaler",
           "HybridParallelGradScaler", "worker_num", "worker_index",
           "is_first_worker", "barrier_worker"]

_strategy: Optional[DistributedStrategy] = None
_hcg: Optional[HybridCommunicateGroup] = None


def init(role_maker=None, is_collective=True, strategy=None):
    """Record ``strategy`` (a default one when None), join the launcher's
    process group when there is one, and build the mesh and its groups.
    Raises ``NotImplementedError`` for what the port does not run yet."""
    global _strategy, _hcg
    strategy = strategy or DistributedStrategy()
    strategy.check()
    if collective.launcher_world_size() > 1 or collective.is_initialized():
        collective.init_parallel_env()
    _strategy = strategy
    _hcg = HybridCommunicateGroup(strategy)
    return _hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _hcg is None:
        init()
    return _hcg


def get_strategy() -> DistributedStrategy:
    if _strategy is None:
        init()
    return _strategy


def distributed_model(model):
    """Place ``model`` on the mesh for the strategy's sharding stage (its
    tp layers split, its pp chunks kept, its stage-3 parameters
    sharded), or whole under a comm-efficient strategy."""
    s = get_strategy()
    mesh = get_hybrid_communicate_group().mesh
    if s.comm_modes():
        return place_model(model, mesh, 0, whole=True)
    return place_model(model, mesh, s.sharding_stage)


class _FleetOptimizer:
    """What ``distributed_optimizer`` returns: the optimizer's own
    surface, plus ``make_train_step``."""

    def __init__(self, optimizer, strategy):
        self._inner = optimizer
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def make_train_step(self, model, loss_fn, **kw):
        s = self._strategy
        modes = s.comm_modes()
        if len(modes) > 1:
            raise NotImplementedError(
                f"strategies {modes} are mutually exclusive — enable one")
        if not modes:
            amp_level = kw.pop("amp_level", None) or ("O1" if s.amp
                                                      else None)
            return make_train_step(model, self._inner, loss_fn, strategy=s,
                                   amp_level=amp_level, **kw)
        if s.amp:
            raise NotImplementedError(
                "strategy.amp is not supported together with "
                "localsgd/dgc/fp16_allreduce — run them in full "
                "precision")
        if kw:
            raise NotImplementedError(
                f"options {sorted(kw)} are not supported by the "
                f"{modes[0]} train step")
        s.check()
        if s.comm_opt:
            from ..comm_opt import CommOptTrainStep
            cfg = s.comm_opt_configs or {}
            return CommOptTrainStep(
                model, self._inner, loss_fn, strategy=s,
                grad_compress=cfg.get("grad_compress"),
                zero1=bool(cfg.get("zero1", False)),
                tp_overlap=bool(cfg.get("tp_overlap", True)),
                qblock=int(cfg.get("qblock", 1024)))
        if s.a_sync:
            cfg = s.a_sync_configs or {}
            return ce.GeoSGDTrainStep(model, self._inner, loss_fn,
                                      strategy=s,
                                      k_steps=int(cfg.get("k_steps", 0)))
        if s.localsgd:
            cfg = s.localsgd_configs
            return ce.LocalSGDTrainStep(
                model, self._inner, loss_fn, strategy=s,
                k_steps=int(cfg.get("k_steps", 4)),
                begin_step=int(cfg.get("begin_step", 1)))
        if s.dgc:
            cfg = s.dgc_configs
            return ce.DGCTrainStep(
                model, loss_fn, strategy=s, optimizer=self._inner,
                momentum=cfg.get("momentum"),
                sparsity=float(cfg.get("sparsity", 0.99)),
                clip_norm=cfg.get("clip_norm"))
        cfg = s.fp16_allreduce_configs
        return ce.CompressedAllreduceTrainStep(
            model, self._inner, loss_fn, strategy=s,
            dtype=cfg.get("dtype", "bfloat16"))


def distributed_optimizer(optimizer, strategy=None):
    return _FleetOptimizer(optimizer, strategy or get_strategy())


def distributed_scaler(scaler):
    """The reference's ``fleet/scaler.py``: returns ``scaler`` as given.
    The train step reduces ``found_inf`` over every rank before it
    decides, so the ranks agree without a wrapper."""
    return scaler


def worker_num():
    return collective.get_world_size()


def worker_index():
    return collective.get_rank()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    collective.barrier()
