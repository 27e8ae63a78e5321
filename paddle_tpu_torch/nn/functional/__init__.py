from .attention import (attention_path, scaled_dot_product_attention,
                        sdpa_raw)
from .fused_ce import fused_linear_cross_entropy
from .loss import cross_entropy

__all__ = ["attention_path", "scaled_dot_product_attention", "sdpa_raw",
           "fused_linear_cross_entropy", "cross_entropy"]
