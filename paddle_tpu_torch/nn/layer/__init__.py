from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm, rms_norm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm",
           "rms_norm"]
