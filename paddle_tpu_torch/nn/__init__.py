from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (GELU, Conv2D, Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, ReLU, RMSNorm, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
from .moe import MoELayer, SwitchGate, TopKGate

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv2D", "Dropout",
           "Embedding", "GELU", "LayerNorm", "Linear", "MoELayer",
           "MultiHeadAttention", "ReLU", "RMSNorm", "SwitchGate", "Tanh",
           "TopKGate", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
