"""The tensor-parallel matmuls of the serving bodies. Counterpart of
``paddle_tpu/distributed/collective_matmul.py``.

- ``ring_rowparallel_matmul(x, w_local, group)``: the row-parallel
  projection (o-proj, down-proj; GPT's proj and fc2), ``y = sum over the
  tp group of x_local @ w_local``, replicated on return;
- ``matmul_allgather(x, w_local, group)``: the sharded-output matmul (the
  vocab head), ``y = x @ w_local`` gathered along the last dim in group
  rank order.

Here each is the local product plus one collective on the tp group: an
all-reduce (``collective.all_reduce``) or an all-gather along the last dim
(``collective.gather_dim``). The JAX functions decompose the dot into
chunks pipelined over a ring of ``ppermute`` hops, which is how the TPU
overlaps the collective with the dot over its ICI links. The NVLink
counterpart, a collective matmul that overlaps the reduce or the gather
with the product, is queued in ``ROADMAP.md`` (Queue 2) until a machine
with several GPUs can measure it. Both sum in another order than JAX's
ring, so tensor-parallel serving is held to token identity, not to bits,
as in the JAX package.

A group of one rank (or None) makes both the plain product, with no
collective. ``launches`` counts the collectives issued, by kind.
"""
from __future__ import annotations

from . import collective as C

__all__ = ["ring_rowparallel_matmul", "matmul_allgather", "launches"]

#: collectives issued since the last reset, by kind
launches = {"all_reduce": 0, "all_gather": 0}


def _solo(group) -> bool:
    return group is None or group.nranks == 1


def ring_rowparallel_matmul(x, w_local, group):
    """``x [..., k_local] @ w_local [k_local, F]`` summed over ``group``:
    the full ``[..., F]`` result on every rank."""
    y = x @ w_local
    if _solo(group):
        return y
    launches["all_reduce"] += 1
    return C.all_reduce(y, group=group)


def matmul_allgather(x, w_local, group):
    """``x [..., k] @ w_local [k, V_local]`` (this rank's column block),
    gathered along the last dim: ``[..., nranks * V_local]`` on every
    rank."""
    y = x @ w_local
    if _solo(group):
        return y
    launches["all_gather"] += 1
    return C.gather_dim(y, y.dim() - 1, group)
