from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (GELU, AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                    AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                    AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, Conv2D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten, Identity,
                    L1Loss, LayerList, LayerNorm, Linear, MaxPool1D,
                    MaxPool2D, MaxPool3D, MSELoss, MultiHeadAttention, ReLU,
                    RMSNorm, Sequential, SyncBatchNorm, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
from .layer_base import Layer, ParamAttr
from .moe import MoELayer, SwitchGate, TopKGate

__all__ = ["functional", "initializer", "AdaptiveAvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Conv2D", "CrossEntropyLoss", "Dropout",
           "Embedding", "Flatten", "GELU", "Identity", "L1Loss", "Layer",
           "LayerList", "LayerNorm", "Linear", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MoELayer", "MSELoss", "MultiHeadAttention",
           "ParamAttr", "ReLU", "RMSNorm", "Sequential", "SwitchGate",
           "SyncBatchNorm", "Tanh", "TopKGate", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
