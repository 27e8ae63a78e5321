from .activation import gelu, relu, silu, tanh
from .attention import (attention_path, scaled_dot_product_attention,
                        sdpa_raw)
from .common import dropout, linear
from .conv import conv2d
from .fused_ce import fused_linear_cross_entropy
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["attention_path", "scaled_dot_product_attention", "sdpa_raw",
           "fused_linear_cross_entropy", "conv2d", "cross_entropy", "dropout",
           "gelu", "layer_norm", "linear", "relu", "silu", "tanh"]
