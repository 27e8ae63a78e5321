from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm
from .moe import MoELayer, SwitchGate, TopKGate

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding",
           "LayerNorm", "Linear", "MoELayer", "RMSNorm", "SwitchGate",
           "TopKGate"]
