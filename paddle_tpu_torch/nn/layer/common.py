"""Common layers. Counterpart of ``paddle_tpu/nn/layer/common.py``.

Every layer is an ``nn.Layer``. ``Linear.weight`` keeps the paddle layout
``[in, out]`` and is applied as ``x @ W + b``, so state dicts carry across
without transposes. Weights follow the JAX package's initialisers
(``nn.initializer``: Xavier-uniform weights, zero biases, N(0, 1)
embeddings) unless a ``ParamAttr`` names another, drawn from
``framework.random_seed.generator(device)`` in float32 and cast to the
requested dtype. ``Embedding(padding_idx=)`` zeroes that row at
construction and masks its lookups (so its gradient is zero), as the JAX
package does. The dropouts follow ``Layer.training``.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal, XavierUniform
from ..layer_base import Layer
from ..param_attr import make_parameter

__all__ = ["AlphaDropout", "Bilinear", "ChannelShuffle", "CosineSimilarity",
           "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Flatten",
           "Fold", "Identity", "Linear", "Pad1D", "Pad2D", "Pad3D",
           "PairwiseDistance", "PixelShuffle", "PixelUnshuffle",
           "Softmax2D", "Unfold", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "ZeroPad2D"]


class Linear(Layer):
    """y = x @ W + b, weight ``[in, out]``; ``bias_attr=False`` drops the
    bias (zeros by default), as in the JAX package."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = make_parameter((self.in_features, self.out_features),
                                     weight_attr, dtype, False,
                                     XavierUniform(), device)
        self.bias = make_parameter((self.out_features,), bias_attr, dtype,
                                   True, None, device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Dropout(Layer):
    """Zeroes elements with probability ``p`` while ``self.training``
    (``F.dropout``: "upscale_in_train" scales the kept ones by
    ``1 / (1 - p)``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Embedding(Layer):
    """Token lookup, weight ``[num_embeddings, embedding_dim]``, N(0, 1)
    unless ``weight_attr`` says otherwise. A negative ``padding_idx``
    counts from the end. ``sparse`` is accepted and changes nothing (the
    gradient is dense, as in the JAX package)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._num_embeddings = int(num_embeddings)
        self._embedding_dim = int(embedding_dim)
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else self._num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = make_parameter(
            (self._num_embeddings, self._embedding_dim), weight_attr, dtype,
            False, Normal(0.0, 1.0), device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(Layer):
    """Flattens the axes ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Bilinear(Layer):
    """``out[b, o] = x1[b] @ W[o] @ x2[b] + bias[o]``, weight ``[out, in1,
    in2]`` (Xavier-uniform by the JAX package's fans), bias zeros."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = make_parameter(
            (out_features, in1_features, in2_features), weight_attr, dtype,
            False, None, device)
        self.bias = make_parameter((out_features,), bias_attr, dtype, True,
                                   None, device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadNd(Layer):
    def __init__(self, padding, mode, value=0.0, data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[N, C, H, W]`` (axis -3)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
