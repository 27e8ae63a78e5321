"""``paddle.amp``: mixed precision. Counterpart of ``paddle_tpu/amp``."""
from .auto_cast import amp_guard, amp_state, auto_cast, decorate
from .grad_scaler import GradScaler

__all__ = ["amp_guard", "amp_state", "auto_cast", "decorate", "GradScaler"]
