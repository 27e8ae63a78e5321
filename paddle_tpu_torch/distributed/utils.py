"""The MoE token-dispatch collectives. Counterpart of
``paddle_tpu/distributed/utils.py`` (``global_scatter``,
``global_gather``; reference ``distributed/utils.py:57,180``).

Layout contract (the reference's):

- counts index i enumerates (card, expert) pairs card-major: card
  ``i // n_expert``, expert ``i % n_expert``;
- ``global_scatter``'s input rows are grouped in ``local_count`` order
  (card-major); its output rows are grouped expert-major: for each local
  expert e, the rows from cards 0..W-1 in order, ``global_count[r*E + e]``
  rows each;
- ``global_gather`` is the inverse permutation, so
  ``global_gather(global_scatter(x))`` returns the rows to their senders
  in their first order.

Over a group of more than one rank both follow the JAX package's SPMD
layout: each (card, expert) bucket is padded to ``capacity`` rows (the
local row count by default) and everything moves in ONE equal-split
``collective.alltoall_single``; the result has ``n_expert * W *
capacity`` rows, the first ``sum(counts)`` valid and the rest zero. The
padded layout needs no uneven split sizes, which gloo may not carry on
CUDA tensors. At world size 1 card-major and expert-major coincide: the
dispatch is the identity on the first ``sum(counts)`` rows (an exact
dynamic shape, as the reference kernel's). Both are differentiable: the
backward of a scatter is the matching gather, and the reverse.

This API exists for parity and migration; ``nn.MoELayer`` dispatches by
sorting instead, with no padded buckets.
"""
from __future__ import annotations

import torch

from . import collective as C

__all__ = ["global_scatter", "global_gather"]

_X_DTYPES = ("float16", "bfloat16", "float32", "float64", "int32", "int64")


def _check_dispatch_args(x, local_count, global_count, name):
    for t, nm, ok in ((x, "x", _X_DTYPES),
                      (local_count, "local_count", ("int32", "int64")),
                      (global_count, "global_count", ("int32", "int64"))):
        dt = str(getattr(t, "dtype", "")).replace("torch.", "")
        if dt not in ok:  # exact match: 'uint32' must not pass as 'int32'
            raise TypeError(
                f"The data type of '{nm}' in {name} must be one of {ok}, "
                f"but received {dt}.")


def _bucket_rows(xd, counts, capacity):
    """Gather each count-delimited bucket of ``xd`` into a padded
    ``[n_buckets, capacity, ...]`` tensor (invalid slots zero); also the
    ``[n_buckets, capacity]`` validity mask."""
    off = torch.cumsum(counts, 0) - counts
    slot = torch.arange(capacity, device=xd.device)
    idx = off[:, None] + slot[None, :]
    valid = slot[None, :] < counts[:, None]
    rows = xd[idx.clamp(0, max(xd.shape[0] - 1, 0)).reshape(-1)].reshape(
        (counts.shape[0], capacity) + xd.shape[1:])
    pad = valid.reshape(valid.shape + (1,) * (xd.dim() - 1))
    return torch.where(pad, rows, torch.zeros((), dtype=xd.dtype,
                                              device=xd.device)), valid


def _compact_buckets(buckets, counts, capacity):
    """Inverse of ``_bucket_rows``: pack padded buckets contiguously in
    ``counts`` order into ``[n * capacity, ...]``; rows past
    ``sum(counts)`` are zero."""
    n = counts.shape[0]
    out_rows = n * capacity
    off = torch.cumsum(counts, 0) - counts
    slot = torch.arange(capacity, device=buckets.device)
    dest = torch.where(slot[None, :] < counts[:, None],
                       off[:, None] + slot[None, :], out_rows)
    out = buckets.new_zeros((out_rows + 1,) + buckets.shape[2:])
    out[dest.reshape(-1)] = buckets.reshape((-1,) + buckets.shape[2:])
    return out[:out_rows]


def _expert_major(gc, world):
    """``gc`` (card-major) reordered expert-major: bucket (e, r) holds
    ``gc[r * E + e]``."""
    return gc.reshape(world, -1).t().reshape(-1)


def _global_scatter_raw(xd, lc, gc, group, capacity):
    """One rank's scatter over ``group`` (every rank calls it)."""
    world = group.nranks
    n_expert = lc.shape[0] // world
    send, _ = _bucket_rows(xd, lc, capacity)              # [W*E, C, ...]
    send = send.reshape((world, n_expert, capacity) + xd.shape[1:])
    recv = C.alltoall_single(send.contiguous(), group=group)   # recv[r, e]
    buckets = recv.transpose(0, 1).reshape(
        (n_expert * world, capacity) + xd.shape[1:])
    return _compact_buckets(buckets, _expert_major(gc, world), capacity)


def _global_gather_raw(xd, lc, gc, group, capacity):
    """One rank's gather over ``group``: the inverse of
    ``_global_scatter_raw``."""
    world = group.nranks
    n_expert = lc.shape[0] // world
    buckets, _ = _bucket_rows(xd, _expert_major(gc, world), capacity)
    send = buckets.reshape((n_expert, world, capacity) + xd.shape[1:])
    recv = C.alltoall_single(send.transpose(0, 1).contiguous(),
                             group=group)                 # recv[r, e]
    buckets = recv.reshape((world * n_expert, capacity) + xd.shape[1:])
    return _compact_buckets(buckets, lc, capacity)


def _rows(t, n):
    """``t``'s first ``n`` rows, zero-padded when it has fewer."""
    if t.shape[0] >= n:
        return t[:n]
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + t.shape[1:])])


class _Dispatch(torch.autograd.Function):
    """``raw`` forward; the other direction's body on the gradient
    backward (each row moves once, so the adjoint is the inverse
    permutation)."""

    @staticmethod
    def forward(ctx, x, lc, gc, group, capacity, raw, inverse):
        ctx.args = (lc, gc, group, capacity, inverse, x.shape[0])
        return raw(x, lc, gc, group, capacity)

    @staticmethod
    def backward(ctx, g):
        lc, gc, group, capacity, inverse, n = ctx.args
        dx = inverse(g.contiguous(), lc, gc, group, capacity)
        return _rows(dx, n), None, None, None, None, None, None


def _dispatch(x, local_count, global_count, group, name, raw, inverse,
              out_counts_first, capacity):
    _check_dispatch_args(x, local_count, global_count, name)
    lc = torch.as_tensor(local_count, device=x.device).long()
    gc = torch.as_tensor(global_count, device=x.device).long()
    world = C.get_world_size(group)
    if world > 1:
        group = group if group is not None else C.get_group()
        cap = int(capacity) if capacity else int(x.shape[0])
        # a bucket above capacity would drop rows AND misalign the
        # compaction offsets
        for nm, c in (("local_count", lc), ("global_count", gc)):
            if c.numel() and int(c.max()) > cap:
                raise ValueError(
                    f"{name}: max {nm} {int(c.max())} exceeds capacity "
                    f"{cap}; pass capacity= >= the largest (card, expert) "
                    "bucket")
        return _Dispatch.apply(x, lc, gc, group, cap, raw, inverse)
    # world size 1: the identity on the first sum(counts) rows, which
    # only holds when both sides agree on the row total
    lc_sum, gc_sum = int(lc.sum()), int(gc.sum())
    if lc_sum != gc_sum:
        raise ValueError(
            f"{name}: local_count.sum() ({lc_sum}) != global_count.sum() "
            f"({gc_sum}); at world_size 1 the counts must describe the "
            "same rows")
    return x[:int(out_counts_first(lc, gc).sum())]


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True, capacity=None):
    """Distribute the rows of ``x`` to ``n_expert * world_size`` expert
    buckets (reference ``distributed/utils.py:57``; layout in the module
    docstring). Over several ranks the result is capacity-padded, its
    first ``sum(global_count)`` rows valid. None on a rank outside
    ``group``."""
    if group is not None and group.rank < 0:
        return None
    return _dispatch(x, local_count, global_count, group, "global_scatter",
                     _global_scatter_raw, _global_gather_raw,
                     lambda lc, gc: gc, capacity)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True, capacity=None):
    """Gather expert outputs back to the cards that sent the tokens
    (reference ``distributed/utils.py:180``): the inverse of
    ``global_scatter``. Over several ranks the result is
    capacity-padded, its first ``sum(local_count)`` rows valid."""
    if group is not None and group.rank < 0:
        return None
    return _dispatch(x, local_count, global_count, group, "global_gather",
                     _global_gather_raw, _global_scatter_raw,
                     lambda lc, gc: lc, capacity)
