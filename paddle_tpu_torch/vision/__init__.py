"""Vision. Counterpart of ``paddle_tpu/vision``: ``models`` (LeNet, the
ResNet family, the Vision Transformer), ``datasets`` and ``transforms``,
whose public names are also flattened into ``vision`` as the JAX package
does. The other models (VGG, MobileNet, DenseNet, ...) and transforms
are port queue item 9."""
from . import datasets, models, transforms
from .datasets import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .transforms import *  # noqa: F401,F403

__all__ = (["datasets", "models", "transforms"] + models.__all__
           + datasets.__all__ + transforms.__all__)
