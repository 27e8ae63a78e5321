"""``DataParallel`` and ``ParallelEnv``. Counterpart of
``paddle_tpu/distributed/parallel.py``.

In the JAX package a compiled step with the batch sharded over "dp"
averages the gradients by itself, and ``DataParallel`` only keeps the
reference API. In the port each rank runs its own eager loop, so
``apply_collective_grads()`` really averages every gradient over the
data-parallel group (the mesh's dp group, or the ``group`` given):

    model = DataParallel(model)
    loss = model(x).mean(); loss.backward()
    model.apply_collective_grads()
    opt.step()
"""
from __future__ import annotations

import os

from torch import nn

from . import collective
from . import mesh as mesh_mod

__all__ = ["DataParallel", "ParallelEnv"]


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Average every parameter's gradient over the data-parallel
        group, in place."""
        g = self._group or mesh_mod.get_mesh().group("dp")
        if g.nranks == 1:
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                collective.all_reduce(p.grad, collective.ReduceOp.AVG, g)


class ParallelEnv:
    """This process's place in the world: ``rank``, ``world_size`` and
    ``device_id`` (``LOCAL_RANK``)."""

    def __init__(self):
        self.rank = collective.get_rank()
        self.world_size = collective.get_world_size()
        self.device_id = int(os.environ.get("LOCAL_RANK", self.rank))

    @property
    def local_rank(self):
        return self.device_id

    @property
    def nranks(self):
        return self.world_size
