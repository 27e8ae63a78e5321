"""Fleet: the hybrid-parallel training API. Counterpart of
``paddle_tpu/distributed/fleet/__init__.py``:

    fleet.init(is_collective=True, strategy=strategy)   # dp/mp/sharding
    model = fleet.distributed_model(LlamaForCausalLM(cfg))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, ids, lbl: m(ids, labels=lbl))
    loss = step(ids, labels)              # the global batch, on every rank

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
from .base import DistributedStrategy, HybridCommunicateGroup
from .placement import place_model
from .pp_train_step import Pipeline1F1BTrainStep, make_1f1b_train_step
from .train_step import TrainStep, make_train_step
from . import meta_parallel  # noqa: F401

__all__ = ["DistributedStrategy", "HybridCommunicateGroup", "TrainStep",
           "make_train_step", "Pipeline1F1BTrainStep",
           "make_1f1b_train_step", "init", "get_strategy",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "worker_num", "worker_index",
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
    sharded)."""
    stage = get_strategy().sharding_stage
    return place_model(model, get_hybrid_communicate_group().mesh, stage)


class _FleetOptimizer:
    """What ``distributed_optimizer`` returns: the optimizer's own
    surface, plus ``make_train_step``."""

    def __init__(self, optimizer, strategy):
        self._inner = optimizer
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def make_train_step(self, model, loss_fn, **kw) -> TrainStep:
        return make_train_step(model, self._inner, loss_fn,
                               strategy=self._strategy, **kw)


def distributed_optimizer(optimizer, strategy=None):
    return _FleetOptimizer(optimizer, strategy or get_strategy())


def worker_num():
    return collective.get_world_size()


def worker_index():
    return collective.get_rank()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    collective.barrier()
