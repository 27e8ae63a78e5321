"""Tensor-parallel (Megatron) layers. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``.

The JAX layers hold the full weight with a ``"tp"`` PartitionSpec and let
GSPMD insert the collectives. Here each layer holds only this tp rank's
shard, in paddle's ``[in, out]`` layout, and runs the collectives itself
through autograd Functions:

- ``ColumnParallelLinear``: weight ``[in, out/tp]`` (columns of rank r);
  its input goes through identity-forward / all-reduce-backward, and
  ``gather_output`` all-gathers the output columns;
- ``RowParallelLinear``: weight ``[in/tp, out]``; the partial products
  are all-reduced in the forward (identity backward); an input that is
  not already split (``input_is_parallel=False``) is cut to the rank's
  columns first;
- ``VocabParallelEmbedding``: rows ``[V/tp, H]``; a masked lookup of the
  ids in the rank's range, all-reduced;
- ``ParallelCrossEntropy``: the per-token softmax cross-entropy of
  vocab-sharded logits, from the max, exp-sum and label logit merged
  over the group; its backward is local.

A parameter's ``pspec`` is its tp annotation and ``full_shape`` its
logical shape, which the placement rules read. ``split_tp_layers`` swaps
every annotated ``Linear``/``Embedding`` of a model for its parallel
counterpart, slicing the weights it has. A column-parallel layer whose
columns are cut in another order than the contiguous one (GPT's fused
qkv: each rank takes the q, k and v columns of its heads) records that
order as ``column_order`` on its parameters: rank r holds block r of
``full[..., column_order]``, which ``framework.io`` reads and writes.
"""
from __future__ import annotations

import torch
from torch import nn

from ....amp.auto_cast import maybe_cast_compute
from ...collective import ReduceOp, all_reduce, gather_dim

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "copy_to_tp", "reduce_from_tp", "gather_last_dim",
           "vocab_parallel_cross_entropy", "split_tp_layers"]


def _tp_group(group):
    if group is not None:
        return group
    from .. import get_hybrid_communicate_group
    return get_hybrid_communicate_group().get_model_parallel_group()


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (every rank's partial dx of a replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastDim(torch.autograd.Function):
    """All-gather the last dim's shards forward; keep this rank's slice of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.k = x.shape[-1]
        return gather_dim(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        r, k = ctx.group.rank, ctx.k
        return g[..., r * k:(r + 1) * k].contiguous(), None


class _SplitLastDim(torch.autograd.Function):
    """This rank's slice of the last dim forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        k = x.shape[-1] // group.nranks
        return x[..., group.rank * k:(group.rank + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, g.dim() - 1, ctx.group), None


def copy_to_tp(x, group):
    return x if group.nranks == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return x if group.nranks == 1 else _ReduceFromTP.apply(x, group)


def gather_last_dim(x, group):
    return x if group.nranks == 1 else _GatherLastDim.apply(x, group)


def _shard(t, dim, group):
    k = t.shape[dim] // group.nranks
    return t.detach().narrow(dim, group.rank * k, k).clone()


def _param(data, pspec, full_shape):
    p = nn.Parameter(data)
    p.pspec = pspec
    p.full_shape = tuple(full_shape)
    return p


def _check_divides(n, group, what):
    if n % group.nranks:
        raise ValueError(f"{what} ({n}) is not divisible by the "
                         f"tensor-parallel degree {group.nranks}")


class ColumnParallelLinear(nn.Module):
    """y = x @ W[:, cols of rank r] (+ b), W ``[in, out]`` split over the
    output dim; ``gather_output`` returns the full ``[..., out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype="float32"):
        super().__init__()
        full = pnn.Linear(in_features, out_features, weight_attr,
                          None if has_bias else False, device=device,
                          dtype=dtype)
        self._take(full, mp_group, gather_output)

    @classmethod
    def from_linear(cls, linear, mp_group=None, gather_output=True,
                    column_order=None):
        """The parallel layer holding this rank's columns of ``linear``
        (block r of its columns taken in ``column_order``, when given)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._take(linear, mp_group, gather_output, column_order)
        return self

    def _take(self, linear, mp_group, gather_output, column_order=None):
        g = self.mp_group = _tp_group(mp_group)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        _check_divides(self.out_features, g, "out_features")
        self.gather_output = gather_output
        w, b = linear.weight, linear.bias
        if column_order is not None:
            cols = torch.from_numpy(column_order).to(w.device)
            w = w[:, cols]
            b = None if b is None else b[cols]
        self.weight = _param(_shard(w, 1, g), (None, "tp"), w.shape)
        self.bias = (None if b is None else
                     _param(_shard(b, 0, g), ("tp",), b.shape))
        if column_order is not None:
            for p in self.parameters():
                p.column_order = column_order

    def forward(self, x):
        y = pnn.functional.linear(copy_to_tp(x, self.mp_group), self.weight,
                                  self.bias)
        return gather_last_dim(y, self.mp_group) if self.gather_output \
            else y


class RowParallelLinear(nn.Module):
    """y = sum over ranks of x[..., rows of r] @ W[rows of r] (+ b), W
    ``[in, out]`` split over the input dim; the bias is added once,
    after the sum."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype="float32"):
        super().__init__()
        full = pnn.Linear(in_features, out_features, weight_attr,
                          None if has_bias else False, device=device,
                          dtype=dtype)
        self._take(full, mp_group, input_is_parallel)

    @classmethod
    def from_linear(cls, linear, mp_group=None, input_is_parallel=False):
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._take(linear, mp_group, input_is_parallel)
        return self

    def _take(self, linear, mp_group, input_is_parallel):
        g = self.mp_group = _tp_group(mp_group)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        _check_divides(self.in_features, g, "in_features")
        self.input_is_parallel = input_is_parallel
        self.weight = _param(_shard(linear.weight, 0, g), ("tp", None),
                             linear.weight.shape)
        self.bias = (None if linear.bias is None else
                     _param(linear.bias.detach().clone(), (None,),
                            linear.bias.shape))

    def forward(self, x):
        g = self.mp_group
        if not self.input_is_parallel and g.nranks > 1:
            x = _SplitLastDim.apply(x, g)
        # an amp cast site, as ``F.linear`` (JAX's GSPMD splits the same
        # ``Linear``)
        x, w = maybe_cast_compute(x, self.weight)
        y = reduce_from_tp(x @ w, g)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class VocabParallelEmbedding(nn.Module):
    """Token lookup over vocabulary rows split across the group: rank r
    holds rows ``[r V/tp, (r+1) V/tp)``; ids outside them look up zeros,
    and the sum over the group is the full lookup."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype="float32"):
        super().__init__()
        self._take(pnn.Embedding(num_embeddings, embedding_dim,
                                 device=device, dtype=dtype), mp_group)

    @classmethod
    def from_embedding(cls, emb, mp_group=None):
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._take(emb, mp_group)
        return self

    def _take(self, emb, mp_group):
        g = self.mp_group = _tp_group(mp_group)
        _check_divides(emb.weight.shape[0], g, "num_embeddings")
        self.weight = _param(_shard(emb.weight, 0, g), ("tp", None),
                             emb.weight.shape)
        self.vocab_start = g.rank * self.weight.shape[0]

    def forward(self, ids):
        if self.mp_group.nranks == 1:
            return self.weight[ids]
        local = ids - self.vocab_start
        hit = (local >= 0) & (local < self.weight.shape[0])
        out = self.weight[torch.where(hit, local, 0)]
        out = torch.where(hit[..., None], out, 0.0).to(self.weight.dtype)
        return reduce_from_tp(out, self.mp_group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, vocab_start, ignore_index):
        lf = logits.float()
        m = lf.amax(dim=-1)
        all_reduce(m, ReduceOp.MAX, group)
        shifted = lf - m[..., None]
        e = torch.exp(shifted)
        s = e.sum(dim=-1)
        all_reduce(s, group=group)
        local = labels.long() - vocab_start
        hit = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(hit, local, 0)
        pick = torch.where(hit, shifted.gather(-1, local[..., None])[..., 0],
                           0.0)
        all_reduce(pick, group=group)
        valid = labels != ignore_index
        loss = torch.where(valid, torch.log(s) - pick, 0.0)
        ctx.save_for_backward(e, s, local, hit, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, local, hit, valid = ctx.saved_tensors
        d = e / s[..., None]
        onehot = torch.zeros_like(d).scatter_(-1, local[..., None],
                                              hit[..., None].float())
        d = (d - onehot) * torch.where(valid, g, 0.0)[..., None]
        return d.to(ctx.dtype), None, None, None, None


def vocab_parallel_cross_entropy(logits, labels, group, ignore_index=-100):
    """Per-token CE of vocab-sharded ``logits [..., V/tp]`` (rank r holds
    columns ``[r V/tp, (r+1) V/tp)``) against global int ``labels``, in
    fp32; 0 where the label is ``ignore_index``."""
    return _VocabParallelCE.apply(logits, labels, group,
                                  group.rank * logits.shape[-1],
                                  ignore_index)


class ParallelCrossEntropy(nn.Module):
    """Reference ``c_softmax_with_cross_entropy``: per-token losses
    (``reduction="none"``) of vocab-sharded logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = _tp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return vocab_parallel_cross_entropy(input, label, self.mp_group,
                                            self.ignore_index)


def split_tp_layers(model, group):
    """Swap each ``Linear`` whose weight is annotated ``(None, "tp")`` for
    a ``ColumnParallelLinear`` (output left split; its columns in the
    Linear's ``tp_column_order(tp)`` when it has one), each ``("tp",
    None)`` one for a ``RowParallelLinear`` (input already split), and
    each ``("tp", None)`` ``Embedding`` for a ``VocabParallelEmbedding``,
    each holding this rank's slice of the weights. A dim the degree does
    not divide stays replicated, as the placement rule leaves it."""
    n = group.nranks
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            spec = getattr(getattr(child, "weight", None), "pspec", None)
            w = getattr(child, "weight", None)
            if type(child) is pnn.Linear and spec == (None, "tp") \
                    and w.shape[1] % n == 0:
                order = getattr(child, "tp_column_order", None)
                new = ColumnParallelLinear.from_linear(
                    child, group, False, order(n) if order else None)
            elif type(child) is pnn.Linear and spec == ("tp", None) \
                    and w.shape[0] % n == 0:
                new = RowParallelLinear.from_linear(child, group, True)
            elif type(child) is pnn.Embedding and spec == ("tp", None) \
                    and w.shape[0] % n == 0:
                new = VocabParallelEmbedding.from_embedding(child, group)
            else:
                continue
            setattr(parent, name, new)
    return model


# imported last: nn.moe imports this module's tp collectives, so they must
# exist before nn starts loading
from .... import nn as pnn  # noqa: E402
