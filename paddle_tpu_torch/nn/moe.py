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
form of ``F.gelu``'s default. Expert parallelism (the JAX ``pspec`` on
the expert axis) comes with the multi-GPU slice.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn

from ..ops.ragged_matmul import ragged_dot
from . import functional as F
from .initializer import XavierUniform
from .layer.common import _param

__all__ = ["TopKGate", "SwitchGate", "MoELayer"]


def _one_hot(idx, n, dtype):
    """One-hot over the last axis; an index outside ``[0, n)`` gives an
    all-zero row (``jax.nn.one_hot``'s rule; torch's raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_gating(logits, k, capacity):
    """Dense routing of fp32 ``logits [S, E]``: (dispatch ``[S, E, C]``,
    combine ``[S, E, C]``, aux load-balance loss)."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = torch.topk(gates, k, dim=-1)
    mask_k = _one_hot(topk_idx, E, gates.dtype)                # [S, k, E]
    frac = mask_k[:, 0].mean(dim=0)
    aux = E * (gates.mean(dim=0) * frac).sum()
    combine = torch.zeros((S, E, capacity), dtype=gates.dtype,
                          device=logits.device)
    prev_counts = torch.zeros((E,), dtype=torch.int32, device=logits.device)
    for choice in range(k):
        m = mask_k[:, choice]                                  # [S, E]
        pos_in_e = (torch.cumsum(m, dim=0) - m).to(torch.int32) \
            + prev_counts[None, :]
        keep = (pos_in_e < capacity).to(gates.dtype) * m
        gate_c = topk_val[:, choice:choice + 1] * keep
        oh_pos = _one_hot(pos_in_e, capacity, gates.dtype)     # [S, E, C]
        combine = combine + gate_c[..., None] * oh_pos * keep[..., None]
        prev_counts = prev_counts + m.sum(dim=0).to(torch.int32)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    dispatch = (combine > 0).to(gates.dtype)
    return dispatch, combine, aux


def _topk_gating_sparse(logits, k, capacity):
    """Sort-based routing of fp32 ``logits [S, E]``. Assignments are
    choice-major (``j = choice * S + token``), so the STABLE sort by
    expert keeps the dense path's capacity priority: every first choice
    claims a slot before any second choice, in token order.

    Returns (e_flat [kS], sort_idx [kS], starts [E], counts [E], slot
    [kS], weight [kS], keep [kS], aux); integers are int64 except
    ``starts`` and ``counts`` (int32, as in the JAX package)."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = torch.topk(gates, k, dim=-1)          # [S, k]
    frac = _one_hot(topk_idx[:, 0], E, gates.dtype).mean(dim=0)
    aux = E * (gates.mean(dim=0) * frac).sum()

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
    keep = (slot < capacity).to(gates.dtype)
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

    def forward(self, x_flat):
        """x_flat: [S, d] -> (dispatch, combine, aux_loss)."""
        return _topk_gating(self._logits(x_flat), self.k,
                            self.capacity(x_flat.shape[0]))

    def forward_sparse(self, x_flat):
        """x_flat: [S, d] -> (e_flat, sort_idx, starts, counts, slot,
        weight, keep, aux_loss)."""
        return _topk_gating_sparse(self._logits(x_flat), self.k,
                                   self.capacity(x_flat.shape[0]))


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
        self.activation = activation
        self.dispatch_mode = dispatch_mode
        self.aux_loss = None

    def _act(self, x):
        if self.activation == "gelu":
            return F.gelu(x, approximate=True)    # jax.nn.gelu's default
        return F.relu(x) if self.activation == "relu" else F.silu(x)

    def resolve_dispatch(self, S):
        """"dense" or "sparse": the dispatch ``forward`` takes for ``S``
        tokens."""
        if self.dispatch_mode != "auto":
            return self.dispatch_mode
        C = self.gate.capacity(S)
        return ("dense" if S * self.num_experts * C
                <= self.DENSE_DISPATCH_LIMIT else "sparse")

    def forward(self, x):
        """x: [B, L, d] -> [B, L, d]."""
        b, l, d = x.shape
        x_flat = x.reshape(b * l, d)
        S = b * l
        out = (self._forward_dense(x_flat)
               if self.resolve_dispatch(S) == "dense"
               else self._forward_sparse(x_flat, S, self.gate.capacity(S)))
        return out.reshape(b, l, d)

    def _forward_dense(self, x_flat):
        """The four einsums over ``[S, E, C]``, in the promoted dtype of x
        and the fp32 routing tensors as in the JAX package; the result is
        cast back to x's dtype (the JAX layer hands a bf16 model an fp32
        result)."""
        dispatch, combine, aux = self.gate(x_flat)
        self.aux_loss = aux
        dt = torch.promote_types(x_flat.dtype, dispatch.dtype)
        xf, disp, comb = x_flat.to(dt), dispatch.to(dt), combine.to(dt)
        expert_in = torch.einsum("sd,sec->ecd", xf, disp)
        h = self._act(torch.bmm(expert_in, self.w_up.to(dt)))
        expert_out = torch.bmm(h, self.w_down.to(dt))
        return torch.einsum("ecd,sec->sd", expert_out, comb).to(x_flat.dtype)

    def _forward_sparse(self, x_flat, S, C):
        """Sort-based dispatch and combine: routing memory O(kS·d + E·C·d),
        never ``[S, E, C]``. Queue slot (e, c) holds sorted assignment
        ``starts[e] + c`` while ``c < min(counts[e], C)``; combine gathers
        each assignment's expert output, weights it and sums the k choices
        of a token with a reshape (choice-major layout, no scatter)."""
        e_flat, sort_idx, starts, counts, slot, w, keep, aux = \
            self.gate.forward_sparse(x_flat)
        self.aux_loss = aux
        E, k = self.num_experts, self.gate.k
        d = x_flat.shape[-1]
        kS = e_flat.shape[0]
        c_idx = torch.arange(C, device=x_flat.device)
        gpos = starts.long()[:, None] + c_idx[None, :]             # [E, C]
        live = counts.clamp_max(C)                                 # int32
        valid = c_idx[None, :] < live[:, None]
        tok = sort_idx[gpos.clamp(0, kS - 1)] % S                  # [E, C]
        expert_in = x_flat[tok] * valid[..., None].to(x_flat.dtype)
        if self.expert_kernel == "ragged":
            # row tiles past each expert's live count skip their product
            h = self._act(ragged_dot(expert_in, self.w_up, live))
            expert_out = ragged_dot(h, self.w_down, live)
        else:
            h = self._act(torch.bmm(expert_in, self.w_up))
            expert_out = torch.bmm(h, self.w_down)
        flat = expert_out.reshape(E * C, d)
        picked = flat[(e_flat * C + slot).clamp(0, E * C - 1)]
        return (picked * w.to(x_flat.dtype)[:, None]).reshape(k, S, d).sum(0)
