"""Fleet: the training API. Counterpart of
``paddle_tpu/distributed/fleet/__init__.py`` at world size 1:

    model = fleet.distributed_model(LlamaForCausalLM(cfg, device="cuda"))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, ids, lbl: m(ids, labels=lbl))
    loss = step(ids, labels)

``init`` records the strategy; ``distributed_model`` returns the model
as it is (its parameters already live on its device);
``distributed_optimizer`` wraps the optimizer with ``make_train_step``.
"""
from __future__ import annotations

from typing import Optional

from .base import DistributedStrategy
from .train_step import TrainStep, make_train_step

__all__ = ["DistributedStrategy", "TrainStep", "make_train_step", "init",
           "get_strategy", "distributed_model", "distributed_optimizer"]

_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective=True, strategy=None):
    """Record ``strategy`` (a default one when None) for the optimizers
    that ``distributed_optimizer`` wraps later."""
    global _strategy
    _strategy = strategy or DistributedStrategy()


def get_strategy() -> DistributedStrategy:
    if _strategy is None:
        init()
    return _strategy


def distributed_model(model):
    """World size 1: the model as it is."""
    return model


class _FleetOptimizer:
    """What ``distributed_optimizer`` returns: the optimizer's own
    surface, plus ``make_train_step``."""

    def __init__(self, optimizer, strategy):
        self._inner = optimizer
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def make_train_step(self, model, loss_fn, **kw) -> TrainStep:
        bad = self._strategy.unsupported()
        if bad:
            raise NotImplementedError(
                "this strategy needs what the port does not run yet: "
                + "; ".join(f"{s} ({item})" for s, item in bad))
        return make_train_step(model, self._inner, loss_fn,
                               strategy=self._strategy, **kw)


def distributed_optimizer(optimizer, strategy=None):
    return _FleetOptimizer(optimizer, strategy or get_strategy())
