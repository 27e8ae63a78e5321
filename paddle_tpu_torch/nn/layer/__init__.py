from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm, rms_norm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm",
           "rms_norm", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
