from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activations
from .attention import (attention_path, scaled_dot_product_attention,
                        sdpa_raw)
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .extension import *  # noqa: F401,F403
from .extension import __all__ as _extension
from .fused_ce import fused_linear_cross_entropy
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision

__all__ = sorted(_activations + _common + _conv + _extension + _loss
                 + _norm + _pooling + _vision
                 + ["attention_path", "scaled_dot_product_attention",
                    "sdpa_raw", "fused_linear_cross_entropy"])
