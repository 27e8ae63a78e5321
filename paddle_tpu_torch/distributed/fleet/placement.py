"""Placing a model on the hybrid mesh: what ``fleet.distributed_model``
does, and the stage-3 parameter gathering the train step runs.

``place_model(model, mesh, stage)``:

0. at pp > 1, refuses pp beside sharding, tp or sep (``mesh.pp_guard``);
   at a data degree (dp x sharding) above 1, refuses a model with batch
   norm (``no_batch_norm``: a rank would see its shard's statistics);
   at sep > 1, asks the model whether it runs sequence-parallel
   attention (``check_sequence_parallel``); a model without it is
   refused, since each rank holds only its shard of the sequence;
1. at tp > 1, asks the model (``check_tensor_parallel``) and swaps its
   tp-annotated layers for their ``mp_layers`` counterparts, each holding
   this rank's slice; every MoE layer is told its tp group (whose ranks
   split its experts) and its data group (whose ranks split the batch it
   routes: ``MoELayer.distribute``);
2. gives every parameter its placement ``param.placement =
   infer_param_pspec(full shape, param.pspec, stage)`` (the JAX rule) and
   its logical ``full_shape``;
3. keeps only this rank's block of each parameter whose placement has
   ``"pp"`` (a stacked parameter's chunk of the layers: stage p holds
   layers ``[p L/P, (p + 1) L/P)``) or ``"sharding"``, and at stage 3
   registers ``Stage3`` on the model.

``place_model(model, mesh, 0, whole=True)`` is the placement of the
comm-efficient data-parallel steps (``fleet.comm_efficient``,
``distributed.comm_opt``), the JAX package's for them: nothing is split.
Every parameter stays whole on every rank, tp-annotated ``Linear`` and
``Embedding`` included, except the weights of ``ColumnParallelLinear`` and
``RowParallelLinear`` layers the model itself holds, which keep their
tp slices (``CommOptTrainStep``'s only tp-sharded weights).

``Stage3`` makes the sharded parameters whole only while they are used
(ZeRO-3). The model's units are the children of its ``ModuleList``s (the
decoder layers) and the model itself, for the sharded parameters outside
them (embedding, final norm, head). A forward pre-hook on a unit
all-gathers its parameters' blocks through ``_GatherShard`` and puts the
full tensors in front of the parameters (the owning module's
``__dict__``, which attribute lookup reads before ``_parameters``); the
forward hook drops them. While ``Stage3.saving()`` is active (the train
step's forward), a full tensor that autograd saves for the backward is
stored as its block and gathered again when the backward needs it, so a
full parameter lives from its gather to the end of its unit's forward,
and again in its backward. ``_GatherShard``'s backward reduce-scatters the
full gradient into the block's (summed over the sharding group). Under
remat the checkpoint's own saved-tensor hooks take the layer's tensors
and the layer's forward, gathers included, runs again, to its end, in
the backward.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch import nn
from torch.utils.checkpoint import set_checkpoint_early_stop

from .. import mesh as mesh_mod
from ..collective import gather_dim, reduce_scatter_dim
from .meta_parallel.mp_layers import (ColumnParallelLinear,
                                      RowParallelLinear, split_tp_layers)

__all__ = ["place_model", "placement", "Stage3", "no_batch_norm",
           "no_sequence_parallel"]


def placement(p) -> tuple:
    """A parameter's placement spec (replicated when it has none)."""
    spec = getattr(p, "placement", None)
    return tuple(spec) if spec is not None else (None,) * p.dim()


def no_sequence_parallel(model, sep):
    """The error for a model without sequence-parallel attention on a
    mesh with ``sep`` > 1."""
    return NotImplementedError(
        f"{type(model).__name__} has no sequence-parallel attention, and "
        f"under sep_degree {sep} each rank holds only its shard of the "
        "sequence (the JAX package's GSPMD would gather it instead; the "
        "port refuses: ROADMAP.md, Queue 3, divergences kept on purpose). "
        "Use LlamaForCausalLM with LlamaConfig(sequence_parallel=True)")


def no_batch_norm(model, data):
    """The error for a model with batch norm on a mesh whose data degree
    (dp x sharding) is ``data`` > 1."""
    return NotImplementedError(
        f"{type(model).__name__} has batch norm, and at a data degree of "
        f"{data} (dp x sharding) each rank would normalise with the "
        "statistics of its shard of the batch only (the JAX package's "
        "GSPMD computes them over the global batch). Batch statistics "
        "over the data group and SyncBatchNorm are queued (ROADMAP.md, "
        "port queue item 9): train it at dp = sharding = 1")


def _sharding_dim(spec):
    return spec.index("sharding") if "sharding" in spec else None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(block, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _Regather:
    """A saved full parameter, kept as its block and its view."""

    __slots__ = ("block", "dim", "group", "size", "stride", "offset")

    def __init__(self, block, dim, group, t):
        self.block, self.dim, self.group = block, dim, group
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class Stage3:
    """The sharded parameters of a placed model, by unit (see the module
    docstring)."""

    def __init__(self, model, mesh):
        self.group = mesh.group("sharding")
        owned = {}                       # id(module) -> its unit
        for ml in model.modules():
            if isinstance(ml, nn.ModuleList) and id(ml) not in owned:
                for u in ml:
                    for mod in u.modules():
                        owned[id(mod)] = u
        self._units = {}                 # id(unit) -> [(module, name, p, d)]
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                d = _sharding_dim(placement(p))
                if d is None:
                    continue
                u = owned.get(id(mod), model)
                self._units.setdefault(id(u), (u, []))[1].append(
                    (mod, name, p, d))
        self._live = {}          # storage ptr -> (block, dim, full's ref)
        for u, _ in self._units.values():
            u.register_forward_pre_hook(self._gather)
            u.register_forward_hook(self._drop)

    def _gather(self, unit, args):
        for mod, name, p, d in self._units[id(unit)][1]:
            full = _GatherShard.apply(p, d, self.group)
            mod.__dict__[name] = full
            self._live[full.untyped_storage().data_ptr()] = (
                p, d, weakref.ref(full))

    def _drop(self, unit, args, out):
        for mod, name, p, d in self._units[id(unit)][1]:
            full = mod.__dict__.pop(name)
            self._live.pop(full.untyped_storage().data_ptr(), None)

    def _pack(self, t):
        ptr = t.untyped_storage().data_ptr()
        hit = self._live.get(ptr)
        if hit is None:
            return t
        full = hit[2]()
        if full is None or full.untyped_storage().data_ptr() != ptr:
            del self._live[ptr]          # a stale entry: not a parameter
            return t
        return _Regather(hit[0].detach(), hit[1], self.group, t)

    @staticmethod
    def _unpack(x):
        if not isinstance(x, _Regather):
            return x
        full = gather_dim(x.block, x.dim, x.group)
        return full.as_strided(x.size, x.stride, x.offset)

    @contextlib.contextmanager
    def saving(self):
        """Context for a forward whose backward follows: saved full
        parameters are kept as blocks and gathered again. A remat
        layer's recompute runs to its end (no early stop), so its forward
        hook drops the full parameters it gathered."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack), \
                set_checkpoint_early_stop(False):
            yield


def _whole_placement(model, mesh):
    """The placement of every parameter under ``whole``: its tp slice in
    a ``ColumnParallelLinear``/``RowParallelLinear``, else replicated."""
    tp_ids = {id(p) for m in model.modules()
              if isinstance(m, (ColumnParallelLinear, RowParallelLinear))
              for p in m.parameters(recurse=False)}
    return {id(p): (mesh_mod.infer_param_pspec(p.full_shape, p.pspec, 0,
                                               mesh=mesh)
                    if id(p) in tp_ids else (None,) * p.dim())
            for p in model.parameters()}


def place_model(model, mesh, stage, whole=False):
    """Place ``model`` on ``mesh`` for sharding ``stage`` (once; see the
    module docstring), or, with ``whole``, as the comm-efficient steps
    keep it. Returns the model."""
    placed = getattr(model, "_placed", None)
    if placed is not None:
        if whole:
            want = _whole_placement(model, mesh)
            other = any(want[id(p)] != p.placement
                        for p in model.parameters())
        else:
            other = any(mesh_mod.infer_param_pspec(
                p.full_shape, getattr(p, "pspec", None), stage,
                mesh=mesh) != p.placement for p in model.parameters())
        if (placed.shape != mesh.shape or placed.rank != mesh.rank
                or getattr(model, "_whole", False) != whole or other):
            raise RuntimeError("the model is already placed otherwise "
                               "(another mesh, sharding stage or step)")
        return model
    if whole:
        for p in model.parameters():
            p.full_shape = tuple(getattr(p, "full_shape", p.shape))
        want = _whole_placement(model, mesh)
        for p in model.parameters():
            p.placement = want[id(p)]
        model._placed, model._whole, model._stage3 = mesh, True, None
        return model
    mesh_mod.pp_guard(mesh)
    from ...nn.layer.norm import _BatchNormBase  # nn imports this package
    data = mesh.axis_size("dp") * mesh.axis_size("sharding")
    if data > 1 and any(isinstance(m, _BatchNormBase)
                        for m in model.modules()):
        raise no_batch_norm(model, data)
    sep = mesh.axis_size("sep")
    if sep > 1:
        check = getattr(model, "check_sequence_parallel", None)
        if check is None:
            raise no_sequence_parallel(model, sep)
        check(mesh)
    tp = mesh.axis_size("tp")
    if tp > 1:
        check = getattr(model, "check_tensor_parallel", None)
        if check is None:
            raise NotImplementedError(
                f"{type(model).__name__} under tensor parallel is not in "
                "the port (ROADMAP.md, port queue item 4: multi-GPU)")
        check(tp)
        split_tp_layers(model, mesh.group("tp"))
    from ...nn.moe import MoELayer      # nn imports this package
    for mod in model.modules():
        if isinstance(mod, MoELayer):
            mod.distribute(mesh.group("tp"), mesh.group(("dp", "sharding")))
    for p in model.parameters():
        shape = tuple(getattr(p, "full_shape", p.shape))
        spec = mesh_mod.infer_param_pspec(shape, getattr(p, "pspec", None),
                                          stage, mesh=mesh)
        p.full_shape, p.placement = shape, spec
        if "sharding" in spec or "pp" in spec:   # tp-free: the data is whole
            with torch.no_grad():
                p.data = mesh_mod.local_block(p.data, spec, mesh).clone()
    model._placed = mesh
    model._stage3 = (Stage3(model, mesh)
                     if any("sharding" in placement(p)
                            for p in model.parameters()) else None)
    return model


def saving(model):
    """``Stage3.saving()`` of a placed model, or a no-op context."""
    s3 = getattr(model, "_stage3", None)
    return s3.saving() if s3 is not None else contextlib.nullcontext()
