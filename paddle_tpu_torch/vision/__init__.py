"""Vision models. Counterpart of ``paddle_tpu/vision`` for the Vision
Transformer only (``models.VisionTransformer``, ``vit_s_16``,
``vit_b_16``, ``vit_l_16``, also exported here as the JAX package
flattens its models into ``vision``); the other models, the datasets and
the transforms are port queue item 9."""
from . import models
from .models import VisionTransformer, vit_b_16, vit_l_16, vit_s_16

__all__ = ["models", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_s_16"]
