from . import (activation, common, container, conv, decode, loss, norm,
               pooling, rnn, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = sorted(set().union(*(m.__all__ for m in (
    activation, common, container, conv, decode, loss, norm, pooling, rnn,
    transformer))))
