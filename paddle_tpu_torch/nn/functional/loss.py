"""Losses. Counterpart of ``paddle_tpu/nn/functional/loss.py``: every
function there, with the JAX package's arithmetic where it is not
paddle's.

``cross_entropy``: soft labels (``weight`` is then not read), class
weights, label smoothing (a hard label is smoothed against its one-hot),
``use_softmax=False`` (the input is probabilities, ``log(max(p,
1e-30))``) and any ``axis``. With hard labels "mean" divides by the
weighted count of the labels that are not ``ignore_index``. The default
route (hard labels over the last axis, no weight, no smoothing) is the
dense Llama head's: ``log_softmax`` and one gather.

``ctc_loss`` is the JAX package's alpha recursion in log space over time
(-1e30 for the impossible), on ``log_softmax`` of its input; "mean"
averages ``nll / max(label_length, 1)``. ``edit_distance`` is the
Levenshtein distance of each pair on the host, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cross_entropy", "ctc_loss",
           "dice_loss", "edit_distance", "hinge_embedding_loss",
           "hsigmoid_loss", "kl_div", "l1_loss", "log_loss",
           "margin_cross_entropy", "margin_ranking_loss", "mse_loss",
           "multi_label_soft_margin_loss", "nll_loss", "npair_loss",
           "sigmoid_focal_loss", "smooth_l1_loss", "soft_margin_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss", "triplet_margin_with_distance_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


def _one_hot(idx, k, axis, dtype):
    oh = (idx[..., None] == torch.arange(k, device=idx.device)).to(dtype)
    return torch.movedim(oh, -1, axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """CE of ``input`` (logits, or probabilities with
    ``use_softmax=False``) against int labels (``[...]`` or with a 1 on
    ``axis``) or, with ``soft_label``, distributions; computed in
    ``input``'s dtype."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    axis = axis % input.dim()
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(torch.clamp(input, min=1e-30)))
    k = input.shape[axis]
    if soft_label:
        tgt = label.to(logp.dtype)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        return _reduce(-torch.sum(tgt * logp, dim=axis), reduction)
    li = label.long()
    if li.dim() == logp.dim():                  # [..., 1] int labels
        li = li.squeeze(axis)
    valid = li != ignore_index
    safe = torch.where(valid, li, 0)
    if label_smoothing > 0:
        tgt = ((1 - label_smoothing) * _one_hot(safe, k, axis, logp.dtype)
               + label_smoothing / k)
        loss = -torch.sum(tgt * logp, dim=axis)
    else:
        loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (torch.sum(weight[safe] * valid) if weight is not None
                 else valid.sum().float())
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of ``input [N, C, ...]`` (log-probs over
    axis 1) at int ``label [N, ...]``."""
    li = label.long()
    if li.dim() == input.dim():
        li = li.squeeze(-1)
    valid = li != ignore_index
    safe = torch.where(valid, li, 0)
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (torch.sum(weight[safe] * valid) if weight is not None
                 else valid.sum().float())
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber: ``0.5 d^2`` within ``delta``, ``delta (|d| - delta / 2)``
    outside."""
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    loss = -(label * torch.log(torch.clamp(input, min=1e-12))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    if pos_weight is None:
        loss = (torch.clamp(logit, min=0) - logit * label
                + torch.log1p(torch.exp(-torch.abs(logit))))
    else:
        loss = (label * -TF.logsigmoid(logit) * pos_weight
                + (1 - label) * -TF.logsigmoid(-logit))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log label - input)`` where the label is positive, 0
    elsewhere; "batchmean" divides the sum by the batch."""
    loss = torch.where(label > 0, label * (torch.log(torch.clamp(
        label, min=1e-12)) - input), torch.zeros_like(input))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0] if input.dim() else loss.sum()
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = torch.sum(input1 * input2, -1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def _pdist(a, b, p):
    return torch.sum(torch.abs(a - b) ** p, -1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _pdist(input, positive, p)
    dn = _pdist(input, negative, p)
    if swap:
        dn = torch.minimum(dn, _pdist(positive, negative, p))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss with ``distance_function(a, b)`` (by default the
    Euclidean distance, ``sqrt(sum d^2 + 1e-12)``)."""
    dist = distance_function or (lambda a, b: torch.sqrt(
        torch.sum((a - b) ** 2, dim=-1) + 1e-12))
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label):
    return (input - label) ** 2


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of ``log_probs [T, B, C]`` (logits: ``log_softmax`` is taken)
    against padded ``labels [B, S]``."""
    lp = torch.log_softmax(log_probs, dim=-1)
    lab, il, ll = (t.long() for t in (labels, input_lengths,
                                      label_lengths))
    T, B, _ = lp.shape
    L = 2 * lab.shape[1] + 1
    ext = torch.full((B, L), blank, dtype=torch.long, device=lp.device)
    ext[:, 1::2] = lab
    neg = torch.full((B, 1), -1e30, dtype=lp.dtype, device=lp.device)
    first = torch.full((B, L), -1e30, dtype=lp.dtype, device=lp.device)
    first[:, 0] = lp[0, :, blank]
    first[:, 1] = lp[0].gather(1, ext[:, 1:2])[:, 0]
    same2 = torch.cat([torch.ones((B, 2), dtype=torch.bool,
                                  device=lp.device),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    alphas = [first]
    alpha = first
    for t in range(1, T):
        s1 = torch.cat([neg, alpha[:, :-1]], 1)
        s2 = torch.where(same2, -1e30, torch.cat([neg, neg, alpha[:, :-2]],
                                                 1))
        alpha = (torch.logaddexp(torch.logaddexp(alpha, s1), s2)
                 + lp[t].gather(1, ext))
        alphas.append(alpha)
    alphas = torch.stack(alphas)                            # [T, B, L]
    final = alphas[torch.clamp(il - 1, 0, T - 1),
                   torch.arange(B, device=lp.device)]       # [B, L]
    end1 = final.gather(1, (2 * ll)[:, None])[:, 0]
    end2 = final.gather(1, torch.remainder(2 * ll - 1, L)[:, None])[:, 0]
    nll = -torch.logaddexp(end1, end2)
    if reduction == "mean":
        return torch.mean(nll / torch.clamp(ll.to(nll.dtype), min=1))
    return _reduce(nll, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |p . y| + eps) / (|p| + |y| + eps)`` per sample, averaged;
    ``label [N, ..., 1]`` ints against probabilities ``[N, ..., C]``."""
    y = label.squeeze(-1) if label.shape[-1] == 1 else label
    onehot = (y[..., None] == torch.arange(input.shape[-1],
                                           device=input.device)
              ).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * onehot, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(onehot, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.sum(same, dim=1, keepdim=True)
    xent = torch.mean(torch.sum(-tgt * torch.log_softmax(sim, dim=1), 1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, 1))
                    + torch.mean(torch.sum(positive * positive, 1))) * 0.25
    return xent + reg


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = (torch.clamp(logit, min=0) - logit * label
          + torch.log1p(torch.exp(-torch.abs(logit))))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label.to(input.dtype) * input)),
                   reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    y = label.to(input.dtype)
    term = y * TF.logsigmoid(input) + (1 - y) * TF.logsigmoid(-input)
    if weight is not None:
        term = term * weight
    return _reduce(-torch.mean(term, dim=-1), reduction)


def _hsigmoid_paths(num_classes):
    """Each class's internal nodes and left/right codes on the complete
    binary tree (root 0, class c at leaf ``c + num_classes - 1``)."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    codes = np.zeros((num_classes, depth), np.float32)
    nodes = np.zeros((num_classes, depth), np.int64)
    lengths = np.zeros((num_classes,), np.int64)
    for c in range(num_classes):
        node = c + num_classes - 1
        path = []
        while node > 0:
            parent = (node - 1) // 2
            path.append((parent, node == 2 * parent + 2))
            node = parent
        lengths[c] = len(path)
        for i, (n_, code) in enumerate(reversed(path)):
            nodes[c, i], codes[c, i] = n_, code
    return nodes, codes, lengths


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree:
    ``input [N, D]``, ``label [N]``, ``weight [num_classes - 1, D]``;
    returns ``[N, 1]``."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not supported; "
            "use the default complete binary tree")
    nodes, codes, lengths = (torch.as_tensor(a, device=input.device)
                             for a in _hsigmoid_paths(num_classes))
    y = label.long().reshape(-1)
    yn, yc, yl = nodes[y], codes[y].to(input.dtype), lengths[y]
    logits = torch.einsum("nd,nkd->nk", input, weight[yn])
    if bias is not None:
        logits = logits + bias[yn]
    ll = yc * TF.logsigmoid(logits) + (1 - yc) * TF.logsigmoid(-logits)
    mask = torch.arange(ll.shape[1], device=input.device)[None, :] \
        < yl[:, None]
    return -torch.sum(ll * mask, dim=1, keepdim=True)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: ``cos(m1 theta + m2) - m3`` on the
    target class, times ``scale``; the loss is ``[N, 1]`` before
    ``reduction``."""
    cos = torch.clamp(logits, -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = (label.long().reshape(-1)[:, None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(logits.dtype)
    adjusted = scale * (onehot * target + (1 - onehot) * cos)
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = _reduce(-torch.sum(onehot * logp, dim=-1, keepdim=True),
                   reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


def _levenshtein(s1, s2):
    n = len(s2)
    dp = np.arange(n + 1, dtype=np.float32)
    for x1 in range(1, len(s1) + 1):
        prev = dp.copy()
        dp[0] = x1
        for y1 in range(1, n + 1):
            dp[y1] = min(prev[y1] + 1, dp[y1 - 1] + 1,
                         prev[y1 - 1] + (s1[x1 - 1] != s2[y1 - 1]))
    return dp[n]


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance of each row of ``input`` to ``label`` (the
    first ``*_length`` tokens, ``ignored_tokens`` dropped), divided by the
    label's length when ``normalized``. Returns (float32 ``[B, 1]``, the
    int64 count of pairs), on ``input``'s device."""
    dev = input.device if isinstance(input, torch.Tensor) else "cpu"

    def host(t):
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t))

    a, b = host(input), host(label)
    il = (host(input_length).reshape(-1) if input_length is not None
          else [a.shape[1]] * a.shape[0])
    ll = (host(label_length).reshape(-1) if label_length is not None
          else [b.shape[1]] * b.shape[0])
    drop = set(ignored_tokens or ())
    dists = []
    for i in range(a.shape[0]):
        s1 = [int(t) for t in a[i, :int(il[i])] if int(t) not in drop]
        s2 = [int(t) for t in b[i, :int(ll[i])] if int(t) not in drop]
        d = _levenshtein(s1, s2)
        dists.append([d / max(len(s2), 1) if normalized else d])
    return (torch.as_tensor(np.asarray(dists, np.float32), device=dev),
            torch.as_tensor(np.int64(a.shape[0]), device=dev))

