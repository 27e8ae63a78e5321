from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Linear
from .conv import Conv2D
from .norm import LayerNorm, RMSNorm, rms_norm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Conv2D", "Dropout", "Embedding", "GELU", "LayerNorm", "Linear",
           "ReLU", "RMSNorm", "rms_norm", "MultiHeadAttention", "Tanh",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
