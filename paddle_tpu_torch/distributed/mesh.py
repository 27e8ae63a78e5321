"""Hybrid topology and the placement rules. Counterpart of
``paddle_tpu/distributed/mesh.py``.

The mesh has the JAX package's axes ``("pp", "dp", "sharding", "sep",
"tp")``, tp innermost. Rank r sits where device r sits in the JAX
``build_mesh`` array: ``np.arange(n).reshape(pp, dp, sharding, sep,
tp)``. The JAX package lets GSPMD place a logical array by its
``PartitionSpec``; the port is SPMD, so each rank stores its own block
and acts on the spec with explicit collectives. The placement rules are
the JAX functions, returning the same specs as plain tuples:

- ``data_pspec(shape)``: the batch dim over ``("dp", "sharding")``, or
  replicated when it does not divide;
- ``infer_param_pspec(shape, tp_spec, stage)``: tp specs kept; stage 3
  shards tp-free parameters of at least 1024 elements on their largest
  divisible dim over ``"sharding"``;
- ``opt_state_pspec(param_spec, leaf_shape, param_shape, stage)``
  (``fleet/train_step.py:_opt_state_pspec`` in the JAX package): the
  optimizer state follows the parameter, and stages 1/2 (stage 3 for
  leaves of at least 1024 elements) add ``"sharding"`` on the first free
  divisible dim.

An entry of a spec is None, an axis name, or a tuple of axis names. A
``Mesh`` without process groups (``build_mesh(..., world_size=, rank=)``)
answers these questions for any rank; ``init_groups`` (``fleet.init``)
creates one ``torch.distributed`` group per axis of size > 1, one for
``("dp", "sharding")``, the ranks that split the batch, and one for
``("dp", "sep")``, the ranks whose gradients sum under sequence parallel
(a group whose ranks another group already spans is that group).

Pipeline parallel: a stacked parameter (the layer dim first) is
annotated ``("pp", None, "tp")`` (o and down ``("pp", "tp", None)``),
so ``infer_param_pspec`` places each rank's contiguous chunk of the
layer dim, stage p holding layers ``[p L/P, (p + 1) L/P)``; the batch is
not split over pp (every stage sees the same batch), and ``pp_guard``
refuses pp beside sharding, tp or sep.

Sequence parallel: ``data_pspec`` puts the sequence dim on ``"sep"``, so
each rank of a sep group holds ``[B, L/n]`` of the batch. The train step
declares that with ``sequence_shard(mesh)``; inside it
``current_sequence_shard()`` says which shard this rank holds
(``SequenceShard``: the sep group, the rank's index on it, the degree,
and the ``(dp, sep)`` group whose ranks' losses sum to the global one),
and a model reads it to offset its positions, to run its attention over
the ring and to scale its loss. Outside it a model's input is the whole
sequence.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import collective as C

__all__ = ["AXES", "Mesh", "build_mesh", "set_mesh", "get_mesh",
           "configured_mesh", "mesh_axis_size", "data_pspec",
           "infer_param_pspec", "opt_state_pspec", "spec_axes",
           "local_block", "gather_full", "SequenceShard", "sequence_shard",
           "current_sequence_shard", "sep_guard", "pp_guard"]

AXES = ("pp", "dp", "sharding", "sep", "tp")
# the groups init_groups makes: each axis, the batch-splitting pair, and
# the ranks that sum gradients under sequence parallel
_GROUP_AXES = tuple((a,) for a in AXES) + (("dp", "sharding"), ("dp", "sep"))


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Mesh:
    """The hybrid topology seen from one rank: ``shape`` (axis -> degree,
    as ``jax.sharding.Mesh.shape``), ``ranks`` (the rank grid), and this
    rank's ``coords`` (None for a rank outside the mesh: a mesh may cover
    the first ``size`` ranks of a larger world, as the JAX package may use
    a subset of its devices)."""

    def __init__(self, pp=1, dp=1, sharding=1, sep=1, tp=1, rank=0):
        dims = (pp, dp, sharding, sep, tp)
        self.shape = dict(zip(AXES, (int(d) for d in dims)))
        self.size = int(np.prod(dims))
        self.ranks = np.arange(self.size).reshape(dims)
        self.rank = int(rank)
        self.coords = (dict(zip(AXES, (int(i) for i in np.unravel_index(
            self.rank, dims)))) if self.rank < self.size else None)
        self._groups = {}

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def axis_ranks(self, axes, rank=None) -> list:
        """The ranks that share ``rank``'s coordinates on every axis but
        ``axes``, in mesh order (row-major over ``axes``)."""
        axes = _axes(axes)
        c = dict(zip(AXES, np.unravel_index(
            self.rank if rank is None else rank, self.ranks.shape)))
        idx = tuple(slice(None) if a in axes else c[a] for a in AXES)
        return [int(r) for r in self.ranks[idx].reshape(-1)]

    def axis_index(self, axes) -> int:
        """This rank's position along ``axes`` (row-major, first axis
        major): the index of its block of a dim sharded over them."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def init_groups(self):
        """Create the process group of every axis of size > 1, of
        ``("dp", "sharding")`` and of ``("dp", "sep")``; a group whose
        ranks an earlier one already spans is that group. Every rank of
        the world calls it, members or not, so every rank creates the
        groups in the same order. A mesh whose groups exist keeps them."""
        if self._groups:
            return self
        made = {}
        for axes in _GROUP_AXES:
            if self.axis_size(axes) == 1:
                continue
            for r in range(self.size):
                members = tuple(self.axis_ranks(axes, r))
                if members not in made:
                    made[members] = C.new_group(members, axis_names=axes)
                if r == self.rank:
                    self._groups[axes] = made[members]
        return self

    def group(self, axes) -> C.Group:
        """This rank's group over ``axes``: a one-rank group when their
        size is 1 (every collective over it is the identity)."""
        axes = _axes(axes)
        if self.axis_size(axes) == 1:
            return C.Group(rank=0, nranks=1, ranks=[self.rank],
                           axis_names=axes)
        if axes not in self._groups:
            raise RuntimeError(f"mesh {self.shape}: no process group for "
                               f"{axes}; fleet.init creates them")
        return self._groups[axes]

    def fresh_group(self, axes, backend=None) -> C.Group:
        """A NEW communicator for this rank's group over ``axes``, never
        one an earlier call returned (``init_groups``' groups included):
        every group of ``axes`` is made anew, by every rank of the world
        in the same order, as ``init_groups`` makes them. The serving
        supervisor builds each engine incarnation on one, so a step thread
        it abandoned inside a collective cannot meet the rebuilt engine's
        collectives."""
        axes = _axes(axes)
        mine, made = None, set()
        for r in range(self.size):
            members = tuple(self.axis_ranks(axes, r))
            if members in made:
                continue
            made.add(members)
            g = C.new_group(members, backend=backend, axis_names=axes,
                            fresh=True)
            if self.rank in members:
                mine = g
        return mine

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


_global_mesh: Optional[Mesh] = None


def build_mesh(dp=1, tp=1, pp=1, sharding=1, sep=1, world_size=None,
               rank=None) -> Mesh:
    """The mesh of these degrees (all 1: dp = the world size, as the JAX
    package's ``build_mesh`` takes every device). ``world_size`` and
    ``rank`` default to the process group's."""
    world = C.get_world_size() if world_size is None else int(world_size)
    rank = C.get_rank() if rank is None else int(rank)
    need = dp * tp * pp * sharding * sep
    if need == 1:
        dp = need = world
    if need > world:
        raise ValueError(f"mesh degrees {dp}x{sharding}x{tp}x{pp}x{sep}="
                         f"{need} > {world} ranks")
    return Mesh(pp=pp, dp=dp, sharding=sharding, sep=sep, tp=tp, rank=rank)


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh


def configured_mesh() -> Optional[Mesh]:
    """The mesh ``fleet.init`` or ``set_mesh`` set (or ``get_mesh``'s
    default once made); None before any."""
    return _global_mesh


def get_mesh() -> Mesh:
    """The mesh ``fleet.init`` set, or the default one (every rank on
    dp, its only group the world's)."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh()
        if _global_mesh.size > 1:
            for axes in (("dp",), ("dp", "sharding")):
                _global_mesh._groups[axes] = C.get_group()
    return _global_mesh


def mesh_axis_size(name, mesh=None) -> int:
    return (mesh or get_mesh()).axis_size(name)


def data_pspec(shape, mesh=None) -> tuple:
    """The spec of one batch leaf: the batch dim over (dp, sharding);
    the seq dim over "sep" when it divides. Dims that do not divide stay
    replicated; a scalar gets ()."""
    mesh = mesh or get_mesh()
    shape = tuple(shape)
    if not shape:
        return ()
    dspan = mesh.axis_size(("dp", "sharding"))
    first = ("dp", "sharding") if shape[0] % dspan == 0 else None
    rest = [None] * (len(shape) - 1)
    sep = mesh.axis_size("sep")
    if len(shape) >= 2 and sep > 1 and shape[1] % sep == 0:
        rest[0] = "sep"
    return (first, *rest)


def infer_param_pspec(shape, tp_spec, stage, min_shard_size=1024,
                      mesh=None) -> tuple:
    """A parameter's placement: its tp annotation where the shape honors
    it (size-1 axes become None), and at stage 3 a tp-free parameter of
    at least ``min_shard_size`` elements sharded over "sharding" on its
    largest divisible dim (the first of equal ones)."""
    mesh = mesh or get_mesh()
    ndim = len(shape)
    spec = list(tp_spec) if tp_spec is not None else [None] * ndim
    while len(spec) < ndim:
        spec.append(None)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        size = mesh.axis_size(ax)
        if size == 1 or shape[d] % size != 0:
            spec[d] = None
    if stage >= 3 and int(np.prod(shape)) >= min_shard_size:
        ssize = mesh.axis_size("sharding")
        if ssize > 1 and all(a is None for a in spec):
            cands = [(d, shape[d]) for d in range(ndim)
                     if shape[d] % ssize == 0]
            if cands:
                d = max(cands, key=lambda t: t[1])[0]
                spec[d] = "sharding"
    return tuple(spec)


def opt_state_pspec(param_spec, leaf_shape, param_shape, stage,
                    mesh=None) -> tuple:
    """The spec of one optimizer-state leaf: a scalar or a leaf shaped
    unlike its parameter is replicated; one shaped like it follows the
    parameter's spec, plus "sharding" on the first free divisible dim
    at stages 1/2 (stage 3: leaves of at least 1024 elements) when the
    parameter's spec has no "sharding" yet."""
    mesh = mesh or get_mesh()
    if len(leaf_shape) == 0 or tuple(leaf_shape) != tuple(param_shape):
        return ()
    spec = list(param_spec) + [None] * (len(leaf_shape) - len(param_spec))
    used = set()
    for a in spec:
        used.update(_axes(a))
    if "sharding" not in used and (
            stage in (1, 2)
            or (stage == 3 and int(np.prod(leaf_shape)) >= 1024)):
        ssize = mesh.axis_size("sharding")
        if ssize > 1:
            for d in range(len(leaf_shape)):
                if spec[d] is None and leaf_shape[d] % ssize == 0:
                    spec[d] = "sharding"
                    break
    return tuple(spec)


# -- the partial-manual guard -----------------------------------------------

def _manual_guard(mesh, axis, what, others, item):
    """Refuse ``axis`` (size > 1) beside any of ``others`` of size > 1, as
    the JAX package's partial-manual ``shard_map`` guard refuses it."""
    big = sorted(a for a in others if mesh.axis_size(a) > 1)
    if mesh.axis_size(axis) > 1 and big:
        raise NotImplementedError(
            f"{what} over {axis!r} beside the non-trivial axes {big} is "
            "refused, as the JAX package's partial-manual shard_map guard "
            f"refuses it (ROADMAP.md, port queue item 4: multi-GPU, {item})")


def sep_guard(mesh, axis_name="sep"):
    """The JAX ``_partial_manual_guard``'s rule: a sequence-parallel axis
    beside sharding, tp or pp degrees > 1 is refused. dp is allowed: the
    JAX package's own dp x sep test trains, and the port's losses and
    gradients summed over (dp, sep) give its single-device step."""
    _manual_guard(mesh, axis_name, "sequence parallel",
                  [a for a in ("pp", "sharding", "tp") if a != axis_name],
                  "sequence parallel, with sharding or tp")


def pp_guard(mesh):
    """The same rule for the pipeline (``paddle_tpu/ops/pipeline.py:
    _partial_manual_guard``): pp beside sharding, tp or sep degrees > 1 is
    refused. dp is allowed: the JAX package's own 1F1B test trains pp2 x
    dp2, and gradients averaged over dp give its single-device step."""
    _manual_guard(mesh, "pp", "pipeline parallel", ("sep", "sharding", "tp"),
                  "pipeline parallel, with sharding, tp or sep")


# -- sequence parallel ------------------------------------------------------

@dataclass(frozen=True)
class SequenceShard:
    """This rank's shard of the sequence: block ``index`` of ``n`` along
    the sep ``group``. The losses of the ``loss_group`` ranks (dp x sep)
    sum to the global loss."""
    group: C.Group
    index: int
    n: int
    loss_group: C.Group


_sequence_shard = contextvars.ContextVar("sequence_shard", default=None)


@contextlib.contextmanager
def sequence_shard(mesh=None):
    """Declare that the model inputs inside are this rank's
    ``data_pspec`` shard of the sequence on ``mesh`` (no-op at sep 1)."""
    mesh = mesh or get_mesh()
    n = mesh.axis_size("sep")
    if n == 1:
        yield None
        return
    shard = SequenceShard(mesh.group("sep"), mesh.axis_index("sep"), n,
                          mesh.group(("dp", "sep")))
    token = _sequence_shard.set(shard)
    try:
        yield shard
    finally:
        _sequence_shard.reset(token)


def current_sequence_shard() -> Optional[SequenceShard]:
    """The shard ``sequence_shard`` declared, or None (whole sequences)."""
    return _sequence_shard.get()


# -- acting on a spec --------------------------------------------------------

def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in the order they appear."""
    return tuple(a for e in spec for a in _axes(e))


def local_block(full, spec, mesh=None):
    """This rank's block of the full array or tensor ``full``."""
    mesh = mesh or get_mesh()
    idx = []
    for d, e in enumerate(spec):
        n = mesh.axis_size(e)
        if n == 1:
            idx.append(slice(None))
            continue
        k = full.shape[d] // n
        i = mesh.axis_index(e)
        idx.append(slice(i * k, (i + 1) * k))
    return full[tuple(idx)]


def gather_full(t, spec, mesh=None) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` (placed by
    ``spec``): one all-gather per sharded dim."""
    mesh = mesh or get_mesh()
    for d, e in enumerate(spec):
        if mesh.axis_size(e) > 1:
            t = C.gather_dim(t, d, mesh.group(e))
    return t
