"""The training supervisor's exception that the serving supervisor
shares. Counterpart of the part of ``paddle_tpu/resilience/supervisor.py``
that serving uses: the training ``Supervisor`` (its escalation ladder,
``TrainState``, ``ResumableLoader``) waits for the port's checkpoint
(ROADMAP.md, port queue item 7: training robustness).
"""
from __future__ import annotations

__all__ = ["StepTimeout"]


class StepTimeout(TimeoutError):
    """A supervised step exceeded ``step_timeout_s`` (wedged step)."""
