"""Profiler statistics (reference: python/paddle/profiler/
profiler_statistic.py). Counterpart of
``paddle_tpu/profiler/profiler_statistic.py``.

Two sources, one table shape:

* exported Chrome traces: parsed and aggregated by ``statistic.py``
  (``load_profiler_result`` -> ``build_summary``);
* the **observability span ring**: live in-process spans (train step
  phases, the serving request lifecycle, RecordEvent user ranges)
  aggregated here without any trace export.

``build_span_summary(sorted_by=SortedKeys.CPUTotal)`` renders the ring as
the reference's calls/total/avg/max/min table; ``Profiler.summary``
prints it whenever the tracer is on.
"""
from __future__ import annotations

from . import SortedKeys  # noqa: F401
from .statistic import (ProfilerResult, _Agg, _SORT_FIELD,  # noqa: F401
                        _fmt_table, build_summary, load_profiler_result)

__all__ = ["SortedKeys", "ProfilerResult", "build_summary",
           "load_profiler_result", "gather_span_statistic",
           "build_span_summary"]


def gather_span_statistic():
    """Aggregate the observability span ring into
    ``{name: {"calls", "total", "avg", "max", "min"}}`` (microseconds,
    the exported-trace table's unit). Empty when the tracer is off or
    nothing has been recorded."""
    from ..observability import tracing

    aggs = {}
    for s in tracing.spans():
        if s.get("ph") != "X":
            continue          # instants carry no duration
        aggs.setdefault(s["name"], _Agg()).add(s["dur"] * 1e6)
    return {k: a.as_dict() for k, a in aggs.items()}


def build_span_summary(sorted_by=None, time_unit="ms"):
    """The reference's summary table over live in-process spans,
    sorted by a :class:`SortedKeys` member (CPUTotal default)."""
    field = _SORT_FIELD.get(
        getattr(sorted_by, "name", str(sorted_by)), "total")
    rows = sorted(gather_span_statistic().items(),
                  key=lambda kv: kv[1][field], reverse=True)
    if not rows:
        return "no spans recorded (observability tracer off or idle)"
    return _fmt_table(f"Span Summary (observability ring, sorted by "
                      f"{field})", rows, time_unit)
