"""Utilities. Counterpart of the part of ``paddle_tpu/utils`` that the
training supervisor uses: :class:`TrainingWatchdog`."""
from .watchdog import TrainingWatchdog

__all__ = ["TrainingWatchdog"]
