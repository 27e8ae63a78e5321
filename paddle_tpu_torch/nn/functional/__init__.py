from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .attention import (attention_path, scaled_dot_product_attention,
                        sdpa_raw)
from .common import dropout, linear
from .conv import conv2d
from .fused_ce import fused_linear_cross_entropy
from .loss import cross_entropy, l1_loss, mse_loss
from .norm import batch_norm, layer_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = sorted(_activations + [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d",
    "attention_path", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "batch_norm", "scaled_dot_product_attention", "sdpa_raw",
    "fused_linear_cross_entropy", "conv2d", "cross_entropy",
    "dropout", "l1_loss", "layer_norm", "linear", "max_pool1d",
    "max_pool2d", "max_pool3d", "mse_loss"])
