"""The flat op namespace (``paddle.*``). Counterpart of
``paddle_tpu/tensor_ops``: every op is a plain function on
``torch.Tensor``s (and python scalars, lists, numpy arrays) that keeps
the JAX package's paddle semantics; torch's own operators on a tensor
(``+``, ``@``, ...) stay torch's."""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from . import creation, extras, linalg, logic, manipulation, math, search, stat
from . import random as random_ops

__all__ = sorted(set(
    creation.__all__ + math.__all__ + manipulation.__all__ + logic.__all__
    + search.__all__ + stat.__all__ + linalg.__all__ + random_ops.__all__
    + extras.__all__ + ["einsum"]))
