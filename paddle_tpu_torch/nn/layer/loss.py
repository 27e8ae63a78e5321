"""Loss layers. Counterpart of ``paddle_tpu/nn/layer/loss.py``: each holds
its arguments and calls its ``nn.functional`` loss. ``HSigmoidLoss``
holds the tree's ``weight [num_classes - 1, feature_size]`` (uniform in
``+-2 / sqrt(feature_size)``) and ``bias`` (zeros)."""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import Uniform
from ..layer_base import Layer
from ..param_attr import make_parameter

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CosineEmbeddingLoss",
           "CrossEntropyLoss", "CTCLoss", "HingeEmbeddingLoss",
           "HSigmoidLoss", "KLDivLoss", "L1Loss", "MarginRankingLoss",
           "MSELoss", "MultiLabelSoftMarginLoss", "NLLLoss", "SmoothL1Loss",
           "SoftMarginLoss", "TripletMarginLoss",
           "TripletMarginWithDistanceLoss"]


class _Loss(Layer):
    """``F.<_fn>(*inputs, **self._kw)``."""
    _fn = None

    def __init__(self, **kw):
        super().__init__()
        self._kw = kw

    def forward(self, *inputs):
        return getattr(F, self._fn)(*inputs, **self._kw)


class CrossEntropyLoss(_Loss):
    _fn = "cross_entropy"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax,
                         label_smoothing=label_smoothing)


class MSELoss(_Loss):
    _fn = "mse_loss"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _fn = "l1_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class NLLLoss(_Loss):
    _fn = "nll_loss"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _fn = "cosine_embedding_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class SoftMarginLoss(_Loss):
    _fn = "soft_margin_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class MultiLabelSoftMarginLoss(_Loss):
    _fn = "multi_label_soft_margin_loss"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class TripletMarginWithDistanceLoss(_Loss):
    _fn = "triplet_margin_with_distance_loss"

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(distance_function=distance_function,
                         margin=margin, swap=swap, reduction=reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if is_custom:
            raise NotImplementedError(
                "custom-tree HSigmoid is not supported (default tree only)")
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        c = 2 * math.sqrt(1.0 / feature_size)
        self.weight = make_parameter((num_classes - 1, feature_size),
                                     weight_attr, dtype, False,
                                     Uniform(-c, c), device)
        self.bias = make_parameter((num_classes - 1,), bias_attr, dtype,
                                   True, None, device)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)
