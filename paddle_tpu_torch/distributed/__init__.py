"""Distributed training. Counterpart of ``paddle_tpu/distributed``.

SPMD over ``torch.distributed``: one process per GPU (``spawn`` or
torchrun), each holding its own shards. ``collective`` has the
reference's collectives and point-to-point, ``mesh`` the hybrid topology
and the JAX package's placement rules, ``fleet`` the hybrid train steps
(dp, sharding stages 1-3, tensor, sequence and pipeline parallel),
``parallel`` ``DataParallel`` for eager loops, ``sharding`` the ZeRO
API, ``utils`` the MoE token-dispatch collectives (``global_scatter``,
``global_gather``). Expert parallel is ERNIE-MoE under ``mp_degree``
(``nn.moe``); the comm-efficient strategies are in ROADMAP.md's port
queue item 4.
"""
from . import fleet, mesh, sharding, utils
from .collective import (Group, ReduceOp, all_gather, all_reduce, alltoall,
                         alltoall_single, barrier, broadcast,
                         destroy_process_group, get_group, get_rank,
                         get_world_size, init_parallel_env, is_initialized,
                         new_group, reduce, reduce_scatter, scatter,
                         send, recv, isend, irecv, P2POp,
                         batch_isend_irecv)
from .parallel import DataParallel, ParallelEnv
from .spawn import spawn

__all__ = ["fleet", "mesh", "sharding", "utils", "Group", "ReduceOp",
           "all_gather", "all_reduce", "alltoall", "alltoall_single",
           "barrier", "broadcast", "destroy_process_group", "get_group",
           "get_rank", "get_world_size", "init_parallel_env", "is_initialized",
           "new_group", "reduce", "reduce_scatter", "scatter", "send", "recv",
           "isend", "irecv", "P2POp", "batch_isend_irecv", "DataParallel",
           "ParallelEnv", "spawn"]
