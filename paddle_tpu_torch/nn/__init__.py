from . import decode, functional, initializer, quant
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer import loss
from .layer_base import Layer, ParamAttr
from .moe import MoELayer, SwitchGate, TopKGate

__all__ = sorted(_layers + [
    "decode", "functional", "initializer", "loss", "quant",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
    "clip_grad_norm_", "clip_grad_value_", "Layer", "MoELayer", "ParamAttr",
    "SwitchGate", "TopKGate"])
