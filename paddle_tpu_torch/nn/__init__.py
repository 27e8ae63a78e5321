from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
from .moe import MoELayer, SwitchGate, TopKGate

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding",
           "LayerNorm", "Linear", "MoELayer", "MultiHeadAttention",
           "RMSNorm", "SwitchGate", "TopKGate", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
