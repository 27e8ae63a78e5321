from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .loss import CrossEntropyLoss, L1Loss, MSELoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm, SyncBatchNorm, rms_norm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv2D", "CrossEntropyLoss",
           "Dropout", "Embedding", "Flatten", "GELU", "Identity", "L1Loss",
           "LayerList", "LayerNorm", "Linear", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MSELoss", "ReLU", "RMSNorm", "rms_norm",
           "MultiHeadAttention", "Sequential", "SyncBatchNorm", "Tanh",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
