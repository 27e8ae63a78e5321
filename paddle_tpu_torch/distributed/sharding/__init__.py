"""``paddle.distributed.sharding``: the ZeRO API. Counterpart of
``paddle_tpu/distributed/sharding/__init__.py``.

``group_sharded_parallel(model, optimizer, level)`` maps the levels
"os" / "os_g" / "p_g_os" to sharding stages 1 / 2 / 3 of the fleet
strategy (with every rank on the sharding axis when no topology is set),
and returns the placed model and the fleet optimizer, whose
``make_train_step`` runs the stage; ``scaler`` comes back as given (pass
it to ``make_train_step(scaler=)``). ``offload`` and the buffer sizes are
accepted for the reference API and change nothing.
``save_group_sharded_model`` writes the gathered full weights (rank 0)
and each rank's optimizer state.
"""
from __future__ import annotations

import os

import torch

from .. import collective

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None):
    """Returns ``(model, optimizer, scaler)`` for sharding stage
    ``level`` ("os" 1, "os_g" 2, "p_g_os" 3)."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    from .. import fleet

    strategy = fleet._strategy
    hc = strategy.hybrid_configs if strategy is not None else {}
    nontrivial = any(hc.get(k, 1) > 1 for k in ("dp_degree", "mp_degree",
                                                 "pp_degree", "sep_degree"))
    if strategy is None or (not nontrivial
                            and hc.get("sharding_degree", 1) <= 1):
        # no topology to keep: every rank on the sharding axis
        strategy = strategy or fleet.DistributedStrategy()
        strategy.hybrid_configs = dict(strategy.hybrid_configs)
        strategy.hybrid_configs.update(
            dp_degree=1, mp_degree=1, pp_degree=1,
            sharding_degree=collective.get_world_size())
        fleet.init(is_collective=True, strategy=strategy)
    elif hc.get("sharding_degree", 1) <= 1:
        raise RuntimeError(
            "group_sharded_parallel: the active fleet strategy has "
            "sharding_degree<=1; set hybrid_configs['sharding_degree'] "
            "before fleet.init, or call group_sharded_parallel without "
            "initializing fleet first")
    strategy.sharding = True
    strategy.sharding_configs["sharding_stage"] = _LEVELS[level]
    model = fleet.distributed_model(model)
    optimizer = fleet.distributed_optimizer(optimizer, strategy=strategy)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Write ``output/model.pdparams`` (the full weights as numpy arrays,
    gathered from every rank and written by rank 0) and, with an
    optimizer, ``output/model.pdopt`` (its ``state_dict()``; one file per
    rank, ``model.pdopt.<rank>``, when there are several). Every rank
    calls it."""
    from ...framework.io import gather_state_dict

    os.makedirs(output, exist_ok=True)
    inner = getattr(model, "_layers", model)
    full = gather_state_dict(inner)
    rank, world = collective.get_rank(), collective.get_world_size()
    if rank == 0:
        torch.save(full, os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        name = "model.pdopt" if world == 1 else f"model.pdopt.{rank}"
        torch.save(optimizer.state_dict(), os.path.join(output, name))
