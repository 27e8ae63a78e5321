"""Metrics. Counterpart of ``paddle_tpu/metric`` (``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc``, ``accuracy``), with the
same host-side numpy arithmetic: predictions and labels (tensors on any
device, or arrays) are read to the host once per ``compute`` or
``update``. ``Accuracy.compute`` and ``accuracy`` return CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]


def _host(x):
    """A tensor or array-like as a numpy array (bf16 read as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p = _host(pred)
        l = _host(label)
        idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        if l.ndim == p.ndim:
            l = l.squeeze(-1)
        correct = idx == l[..., None]
        return torch.from_numpy(np.asarray(correct, dtype=np.float32))

    def update(self, correct, *args):
        c = _host(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        flat = c.reshape(-1, c.shape[-1])
        for i, k in enumerate(self.topk):
            self.total[i] += flat[:, :k].sum()
            self.count[i] += flat.shape[0]
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        pred_pos = (p > 0.5).reshape(-1)
        lab = l.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fp += int(np.sum(pred_pos & ~lab))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        pred_pos = (p > 0.5).reshape(-1)
        lab = l.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fn += int(np.sum(~pred_pos & lab))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = l.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(int),
                          self.num_thresholds)
        for b, lab in zip(bins, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    p = _host(input)
    l = _host(label).reshape(-1)
    idx = np.argsort(-p, axis=-1)[:, :k]
    correct_ = (idx == l[:, None]).any(axis=1)
    return torch.from_numpy(np.asarray([correct_.mean()], dtype=np.float32))
