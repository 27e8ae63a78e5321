"""Profiler utilities (reference: python/paddle/profiler/utils.py).
Counterpart of ``paddle_tpu/profiler/utils.py``:

* :class:`RecordEvent` / :class:`RecordInstantEvent`: user ranges that
  land both in the ``torch.profiler`` trace and the observability span
  ring.
* :func:`in_profiler_mode`: True while any ``Profiler`` is started.
* :func:`wrap_optimizers`: the reference patches every optimizer's
  ``step`` with an ``Optimization Step`` RecordEvent; here
  ``Optimizer.step`` emits a ``train.optimizer`` span whenever the
  observability tracer is on, so this idempotently enables the tracer.
"""
from __future__ import annotations

from . import RecordEvent, RecordInstantEvent  # noqa: F401

__all__ = ["RecordEvent", "RecordInstantEvent", "in_profiler_mode",
           "wrap_optimizers"]


def in_profiler_mode():
    """True while at least one ``profiler.Profiler`` is started."""
    from . import _ACTIVE_PROFILERS

    return _ACTIVE_PROFILERS > 0


def wrap_optimizers():
    """Make optimizer steps visible as spans: ``Optimizer.step`` already
    emits a ``train.optimizer`` span whenever the observability tracer is
    on, so wrapping == enabling the tracer. Idempotent."""
    from ..observability import tracing

    tracing.enable()
