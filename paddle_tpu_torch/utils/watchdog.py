"""Training failure detection. Counterpart of
``paddle_tpu/utils/watchdog.py``, copied as is (it imports no JAX).

Watches step wall-time and loss health; on anomaly it invokes callbacks
(checkpoint, skip-step). Pure host-side logic: no device sync beyond the
loss scalar the loop already has. The *recovering* superstructure grown
on top of this detector lives in ``paddle_tpu_torch.resilience.Supervisor``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

__all__ = ["TrainingWatchdog"]


class TrainingWatchdog:
    def __init__(self, step_timeout_s: float = 600.0,
                 nan_patience: int = 5,
                 on_stall: Optional[Callable] = None,
                 on_nan: Optional[Callable] = None):
        self.step_timeout_s = step_timeout_s
        self.nan_patience = nan_patience
        self.on_stall = on_stall
        self.on_nan = on_nan
        # armed lazily: a watchdog built long before training begins must
        # not report the setup gap as a phantom stall on step 1
        self._last_step_t = None
        self._nan_streak = 0
        self.stats = {"steps": 0, "nan_steps": 0, "stalls": 0}

    def start(self):
        """Arm the stall timer now (optional — the first step() arms it
        implicitly). Call right before the training loop if setup work
        between the first two steps should count toward the timeout."""
        self._last_step_t = time.monotonic()
        return self

    def step(self, loss_value: float) -> bool:
        """Record one step. Returns True if the step is healthy (usable)."""
        now = time.monotonic()
        if self._last_step_t is None:
            self._last_step_t = now     # first step arms the timer
        if now - self._last_step_t > self.step_timeout_s:
            self.stats["stalls"] += 1
            if self.on_stall:
                self.on_stall(now - self._last_step_t)
        self._last_step_t = now
        self.stats["steps"] += 1
        healthy = loss_value is None or math.isfinite(float(loss_value))
        if not healthy:
            self.stats["nan_steps"] += 1
            self._nan_streak += 1
            if self.on_nan:
                self.on_nan(self._nan_streak)
            if self._nan_streak >= self.nan_patience:
                raise FloatingPointError(
                    f"loss non-finite for {self._nan_streak} consecutive steps")
        else:
            self._nan_streak = 0
        return healthy
