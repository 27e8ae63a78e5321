"""Distributed training. Counterpart of ``paddle_tpu/distributed``.

SPMD over ``torch.distributed``: one process per GPU (``spawn`` or
torchrun), each holding its own shards. ``collective`` has the
reference's collectives, ``mesh`` the hybrid topology and the JAX
package's placement rules, ``fleet`` the hybrid train step (dp, sharding
stages 1-3, tensor parallel), ``parallel`` ``DataParallel`` for eager
loops, ``sharding`` the ZeRO API. Pipeline and sequence parallel,
expert parallel and the comm-efficient strategies are in ROADMAP.md's
port queue item 4.
"""
from . import fleet, mesh, sharding
from .collective import (Group, ReduceOp, all_gather, all_reduce, alltoall,
                         alltoall_single, barrier, broadcast,
                         destroy_process_group, get_group, get_rank,
                         get_world_size, init_parallel_env, is_initialized,
                         new_group, reduce, reduce_scatter, scatter)
from .parallel import DataParallel, ParallelEnv
from .spawn import spawn

__all__ = ["fleet", "mesh", "sharding", "Group", "ReduceOp", "all_gather",
           "all_reduce", "alltoall", "alltoall_single", "barrier",
           "broadcast", "destroy_process_group", "get_group", "get_rank",
           "get_world_size", "init_parallel_env", "is_initialized",
           "new_group", "reduce", "reduce_scatter", "scatter",
           "DataParallel", "ParallelEnv", "spawn"]
