"""Mixture-of-Experts. Counterpart of ``paddle_tpu/nn/moe.py``.

GShard-style, as in the JAX package: the experts are one batched
parameter per projection (``w_up [E, d, f]``, ``w_down [E, f, d]``), and
each expert's queue holds at most ``capacity`` tokens. Two dispatches:

- dense: ``[S, E, C]`` one-hot dispatch and combine tensors and four
  einsums (``_topk_gating``);
- sparse: sort-based routing (``_topk_gating_sparse``): the ``k * S``
  (expert, token) assignments sorted by expert, each assignment's slot in
  its expert's queue read off the inverse permutation, per-expert starts
  and counts by binary search; dispatch and combine are gathers.

``dispatch_mode="auto"`` takes dense while ``S * E * C`` stays within
``DENSE_DISPATCH_LIMIT`` and sparse above it. Under sparse dispatch the
expert FFNs run as ``torch.bmm`` over the full capacity
(``expert_kernel="einsum"``) or through the ragged grouped-matmul kernel
(``"ragged"``, ``ops.ragged_matmul.ragged_dot``), whose row tiles past
each expert's live count skip their product. The default is "einsum"
unless the environment sets ``PADDLE_TPU_MOE_RAGGED=1``, the JAX
package's rule. The per-expert counts stay on the device: nothing on the
path reads them on the host.

``jax.lax.top_k`` breaks ties by the lower expert index; ``torch.topk``
on CUDA promises no order. A tie needs two equal fp32 gates of one
token, which random or trained inputs do not give.

The expert activation is the JAX ``MoELayer._act``'s: ``jax.nn.gelu``'s
default, the tanh form (``F.gelu(approximate=True)``), not the exact
form of ``F.gelu``'s default.

Across ranks (``fleet.distributed_model`` calls ``distribute``): the
JAX package routes the GLOBAL batch, so a layer whose batch is split
over the data group (dp x sharding) routes as if it held all of it:
capacity from the global token count, the load-balance loss from global
means (all-reduced), and each assignment's place in its expert's queue
counted over the assignments of every rank ahead of it (one all-gather
of the per (choice, expert) counts). A rank still computes only its own
tokens.

Expert parallelism: the banks carry the JAX package's ``pspec`` ``("tp",
None, None)`` (unless the expert count does not divide the mesh's tp
degree: then they stay replicated, with the JAX package's warning), and
at tp > 1 ``distribute`` cuts them to this rank's experts ``[r E/tp,
(r+1) E/tp)``. Every tp rank sees the same tokens and routes them with
the same replicated gate; each then runs only its experts on their
queues (the ragged kernel on ``[E/tp, C, d]``) and combines only the
assignments that landed on them; ``reduce_from_tp`` sums the ranks'
parts (its backward is the identity: every rank holds the same
cotangent). The expert input passes ``copy_to_tp`` (identity forward; the
backward sums the ranks' shares of dx, each holding only its own
experts'), and so do the routing weights (each rank's gradient reaches
only the weights of its own assignments); the gate's input does not: its
gradient is whole on every rank. A layer moves ``S * d`` a forward,
not an all-gather of the ``E * C * d`` expert outputs.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn

from ..distributed.collective import Group, all_reduce, gather_dim
from ..distributed.fleet.meta_parallel.mp_layers import (_shard, copy_to_tp,
                                                          reduce_from_tp)
from ..ops.ragged_matmul import ragged_dot
from . import functional as F
from .initializer import XavierUniform
from .param_attr import _param

__all__ = ["TopKGate", "SwitchGate", "MoELayer"]

# one rank: every collective over this group is the identity
_ONE = Group(rank=0, nranks=1, axis_names=())


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) forward and backward: a sum over the data group
    that every rank's loss uses whole (the load-balance loss's means)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


def _mean_over(t, group):
    """The mean over dim 0 of ``t`` across the group's ranks (each holding
    an equal block of rows)."""
    if group.nranks == 1:
        return t.mean(dim=0)
    return _SumOver.apply(t.sum(dim=0), group) / (t.shape[0] * group.nranks)


def _ahead(per, group):
    """``[k, E]``: for each (choice, expert), the assignments to that
    expert ahead of this rank's choice-``c`` block in the global batch's
    choice-major order (every rank's earlier choices, then the earlier
    ranks' same choice). ``per`` counts this rank's."""
    before = per.cumsum(0) - per
    if group.nranks == 1:
        return before
    every = gather_dim(per[None].contiguous(), 0, group)          # [n, k, E]
    total = every.sum(0)
    return total.cumsum(0) - total + every[:group.rank].sum(0)


def _one_hot(idx, n, dtype):
    """One-hot over the last axis; an index outside ``[0, n)`` gives an
    all-zero row (``jax.nn.one_hot``'s rule; torch's raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_gating(logits, k, capacity, group=_ONE):
    """Dense routing of fp32 ``logits [S, E]``: (dispatch ``[S, E, C]``,
    combine ``[S, E, C]``, aux load-balance loss); over the global batch
    of ``group``'s ranks (see the module docstring)."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = torch.topk(gates, k, dim=-1)
    mask_k = _one_hot(topk_idx, E, gates.dtype)                # [S, k, E]
    frac = _mean_over(mask_k[:, 0], group)
    aux = E * (_mean_over(gates, group) * frac).sum()
    combine = torch.zeros((S, E, capacity), dtype=gates.dtype,
                          device=logits.device)
    ahead = _ahead(mask_k.sum(dim=0).to(torch.int32), group)  # [k, E]
    for choice in range(k):
        m = mask_k[:, choice]                                  # [S, E]
        pos_in_e = (torch.cumsum(m, dim=0) - m).to(torch.int32) \
            + ahead[choice][None, :]
        keep = (pos_in_e < capacity).to(gates.dtype) * m
        gate_c = topk_val[:, choice:choice + 1] * keep
        oh_pos = _one_hot(pos_in_e, capacity, gates.dtype)     # [S, E, C]
        combine = combine + gate_c[..., None] * oh_pos * keep[..., None]
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    dispatch = (combine > 0).to(gates.dtype)
    return dispatch, combine, aux


def _topk_gating_sparse(logits, k, capacity, group=_ONE):
    """Sort-based routing of fp32 ``logits [S, E]``. Assignments are
    choice-major (``j = choice * S + token``), so the STABLE sort by
    expert keeps the dense path's capacity priority: every first choice
    claims a slot before any second choice, in token order. Over the
    global batch of ``group``'s ranks, an assignment is kept by its place
    in the global queue; ``slot`` stays its place in this rank's, where
    the kept ones come first.

    Returns (e_flat [kS], sort_idx [kS], starts [E], counts [E], slot
    [kS], weight [kS], keep [kS], aux); integers are int64 except
    ``starts`` and ``counts`` (int32, as in the JAX package)."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = torch.topk(gates, k, dim=-1)          # [S, k]
    frac = _mean_over(_one_hot(topk_idx[:, 0], E, gates.dtype), group)
    aux = E * (_mean_over(gates, group) * frac).sum()

    e_flat = topk_idx.t().reshape(-1)                          # choice-major
    w_flat = topk_val.t().reshape(-1)
    sort_idx = torch.argsort(e_flat, stable=True)
    pos = torch.empty_like(sort_idx)                           # inverse perm
    pos[sort_idx] = torch.arange(e_flat.numel(), device=logits.device)
    e_sorted = e_flat[sort_idx]
    experts = torch.arange(E, device=logits.device)
    starts = torch.searchsorted(e_sorted, experts, side="left")
    counts = torch.searchsorted(e_sorted, experts, side="right") - starts
    slot = pos - starts[e_flat]                  # position in own queue
    queued = slot
    if group.nranks > 1:                         # ... in the global queue
        per = _one_hot(topk_idx, E, torch.int64).sum(dim=0)    # [k, E]
        shift = _ahead(per, group) - (per.cumsum(0) - per)
        choice = torch.arange(k, device=logits.device).repeat_interleave(S)
        queued = slot + shift[choice, e_flat]
    keep = (queued < capacity).to(gates.dtype)
    w_flat = w_flat * keep
    # renormalize over this token's kept choices (choice-major reshape)
    denom = w_flat.reshape(k, S).sum(dim=0)
    w_flat = w_flat / denom.repeat(k).clamp_min(1e-9)
    return (e_flat, sort_idx, starts.to(torch.int32), counts.to(torch.int32),
            slot.clamp_max(capacity - 1), w_flat, keep, aux)


class TopKGate(nn.Module):
    """Top-k softmax gate, weight ``[d_model, num_experts]``; logits in
    fp32 whatever the input dtype."""

    def __init__(self, d_model, num_experts, k=2, capacity_factor=1.25, *,
                 device=None, dtype="float32"):
        super().__init__()
        self.num_experts = int(num_experts)
        self.k = int(k)
        self.capacity_factor = capacity_factor
        self.weight = _param((int(d_model), self.num_experts),
                             XavierUniform(), device, dtype)

    def capacity(self, S):
        return max(4, int(math.ceil(self.k * S * self.capacity_factor /
                                    self.num_experts)))

    def _logits(self, x_flat):
        return x_flat.float() @ self.weight.float()

    def forward(self, x_flat, group=_ONE):
        """x_flat: [S, d] -> (dispatch, combine, aux_loss), routed over
        the global batch of ``group``'s ranks."""
        return _topk_gating(self._logits(x_flat), self.k,
                            self.capacity(x_flat.shape[0] * group.nranks),
                            group)

    def forward_sparse(self, x_flat, group=_ONE):
        """x_flat: [S, d] -> (e_flat, sort_idx, starts, counts, slot,
        weight, keep, aux_loss), routed over the global batch of
        ``group``'s ranks."""
        return _topk_gating_sparse(
            self._logits(x_flat), self.k,
            self.capacity(x_flat.shape[0] * group.nranks), group)


class SwitchGate(TopKGate):
    def __init__(self, d_model, num_experts, capacity_factor=1.25, *,
                 device=None, dtype="float32"):
        super().__init__(d_model, num_experts, k=1,
                         capacity_factor=capacity_factor, device=device,
                         dtype=dtype)


class MoELayer(nn.Module):
    """Expert FFN bank + gate; ``forward`` stores ``aux_loss`` for the
    trainer."""

    # dense [S, E, C] dispatch above this many elements takes sparse
    DENSE_DISPATCH_LIMIT = 1 << 22

    def __init__(self, d_model, d_hidden, num_experts, k=2,
                 capacity_factor=1.25, activation="gelu", gate=None,
                 dispatch_mode="auto", expert_kernel=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        if expert_kernel is None:
            expert_kernel = ("ragged"
                             if os.environ.get("PADDLE_TPU_MOE_RAGGED")
                             == "1" else "einsum")
        if expert_kernel not in ("einsum", "ragged"):
            raise ValueError("expert_kernel must be 'einsum' or 'ragged'")
        if dispatch_mode not in ("auto", "dense", "sparse"):
            raise ValueError("dispatch_mode must be 'auto', 'dense' or "
                             "'sparse'")
        if activation not in ("gelu", "relu", "silu"):
            raise ValueError("activation must be 'gelu', 'relu' or 'silu'")
        self.d_model = int(d_model)
        self.num_experts = int(num_experts)
        self.expert_kernel = expert_kernel
        self.gate = gate or TopKGate(d_model, num_experts, k,
                                     capacity_factor, device=device,
                                     dtype=dtype)
        self.w_up = _param((self.num_experts, self.d_model, int(d_hidden)),
                           XavierUniform(), device, dtype)
        self.w_down = _param((self.num_experts, int(d_hidden), self.d_model),
                             XavierUniform(), device, dtype)
        if self._ep_divisible(self.num_experts):
            self.w_up.pspec = ("tp", None, None)
            self.w_down.pspec = ("tp", None, None)
        # set by distribute: the tp group the banks are cut over, and the
        # ranks that split the batch
        self.ep_group = None
        self.data_group = _ONE
        self.activation = activation
        self.dispatch_mode = dispatch_mode
        self.aux_loss = None

    @staticmethod
    def _ep_divisible(num_experts):
        """False (with the JAX package's warning) when the configured
        mesh's tp degree does not divide ``num_experts``."""
        from ..distributed.mesh import configured_mesh
        mesh = configured_mesh()
        tp = mesh.axis_size("tp") if mesh is not None else 1
        if tp > 1 and num_experts % tp != 0:
            import warnings
            warnings.warn(
                f"MoE num_experts={num_experts} not divisible by "
                f"mp_degree={tp}; experts stay replicated (no EP)")
            return False
        return True

    def distribute(self, tp_group, data_group):
        """Place the layer on a mesh (``fleet.distributed_model``): route
        over the global batch of ``data_group``, and at tp > 1 keep this
        rank's block of the experts of annotated banks that the degree
        divides."""
        self.data_group = data_group
        n = tp_group.nranks
        if n == 1 or getattr(self.w_up, "pspec", None) is None \
                or self.num_experts % n:
            return
        for name in ("w_up", "w_down"):
            w = getattr(self, name)
            p = nn.Parameter(_shard(w, 0, tp_group))
            p.pspec, p.full_shape = w.pspec, tuple(w.shape)
            setattr(self, name, p)
        self.ep_group = tp_group

    def _experts(self):
        """(tp group, first expert) of the experts this rank holds: a
        one-rank group and 0 when the banks are whole."""
        g = self.ep_group
        if g is None:
            return _ONE, 0
        return g, g.rank * self.w_up.shape[0]

    def _act(self, x):
        if self.activation == "gelu":
            return F.gelu(x, approximate=True)    # jax.nn.gelu's default
        return F.relu(x) if self.activation == "relu" else F.silu(x)

    def resolve_dispatch(self, S):
        """"dense" or "sparse": the dispatch ``forward`` takes for ``S``
        tokens."""
        if self.dispatch_mode != "auto":
            return self.dispatch_mode
        S = S * self.data_group.nranks          # the global batch's
        C = self.gate.capacity(S)
        return ("dense" if S * self.num_experts * C
                <= self.DENSE_DISPATCH_LIMIT else "sparse")

    def forward(self, x):
        """x: [B, L, d] -> [B, L, d]."""
        b, l, d = x.shape
        x_flat = x.reshape(b * l, d)
        S = b * l
        C = self.gate.capacity(S * self.data_group.nranks)
        out = (self._forward_dense(x_flat)
               if self.resolve_dispatch(S) == "dense"
               else self._forward_sparse(x_flat, S, C))
        return out.reshape(b, l, d)

    def _forward_dense(self, x_flat):
        """The four einsums over ``[S, E, C]``, in the promoted dtype of x
        and the fp32 routing tensors as in the JAX package; the result is
        cast back to x's dtype (the JAX layer hands a bf16 model an fp32
        result)."""
        dispatch, combine, aux = self.gate(x_flat, self.data_group)
        self.aux_loss = aux
        g, e0 = self._experts()
        mine = slice(e0, e0 + self.w_up.shape[0])
        dt = torch.promote_types(x_flat.dtype, dispatch.dtype)
        xf = copy_to_tp(x_flat, g).to(dt)
        disp = dispatch[:, mine].to(dt)
        comb = copy_to_tp(combine, g)[:, mine].to(dt)
        expert_in = torch.einsum("sd,sec->ecd", xf, disp)
        h = self._act(torch.bmm(expert_in, self.w_up.to(dt)))
        expert_out = torch.bmm(h, self.w_down.to(dt))
        out = torch.einsum("ecd,sec->sd", expert_out, comb)
        return reduce_from_tp(out, g).to(x_flat.dtype)

    def _forward_sparse(self, x_flat, S, C):
        """Sort-based dispatch and combine: routing memory O(kS·d + E·C·d),
        never ``[S, E, C]``. Queue slot (e, c) holds sorted assignment
        ``starts[e] + c`` while ``c < min(counts[e], C)``; combine gathers
        each assignment's expert output, weights it and sums the k choices
        of a token with a reshape (choice-major layout, no scatter)."""
        e_flat, sort_idx, starts, counts, slot, w, keep, aux = \
            self.gate.forward_sparse(x_flat, self.data_group)
        self.aux_loss = aux
        g, e0 = self._experts()
        E, k = self.w_up.shape[0], self.gate.k            # this rank's experts
        d = x_flat.shape[-1]
        kS = e_flat.shape[0]
        # an expert's kept assignments lead its queue (min(counts, C) of
        # them on one rank; over the data group, those the global queue
        # kept)
        live = torch.zeros_like(counts).index_add_(
            0, e_flat, keep.to(counts.dtype))[e0:e0 + E]          # int32
        c_idx = torch.arange(C, device=x_flat.device)
        gpos = starts[e0:e0 + E].long()[:, None] + c_idx[None, :]  # [E, C]
        valid = c_idx[None, :] < live[:, None]
        tok = sort_idx[gpos.clamp(0, kS - 1)] % S                  # [E, C]
        xd = copy_to_tp(x_flat, g)
        expert_in = xd[tok] * valid[..., None].to(x_flat.dtype)
        if self.expert_kernel == "ragged":
            # row tiles past each expert's live count skip their product
            h = self._act(ragged_dot(expert_in, self.w_up, live))
            expert_out = ragged_dot(h, self.w_down, live)
        else:
            h = self._act(torch.bmm(expert_in, self.w_up))
            expert_out = torch.bmm(h, self.w_down)
        flat = expert_out.reshape(E * C, d)
        picked = flat[((e_flat - e0) * C + slot).clamp(0, E * C - 1)]
        w = copy_to_tp(w, g)
        if g.nranks > 1:            # only the assignments to this rank's
            w = w * ((e_flat >= e0) & (e_flat < e0 + E))   # experts
        out = (picked * w.to(x_flat.dtype)[:, None]).reshape(k, S, d).sum(0)
        return reduce_from_tp(out, g)
