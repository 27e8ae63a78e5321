"""paddle_tpu_torch.observability: the unified metrics registry and span
tracing across train and serve. Counterpart of
``paddle_tpu/observability``.

Two pieces, one import:

* **Metrics registry** (``metrics``): typed ``Counter`` / ``Gauge`` /
  ``Histogram`` with labels on a process-wide ``REGISTRY``; the existing
  counter sources (serving engines, replica fleets, flight ledgers,
  engine supervisors, comm-opt steps) are attached as pull-time
  collectors, so one ``snapshot()`` / ``to_prometheus()`` scrape sees
  the whole system with zero hot-path cost.
* **Span tracer** (``tracing``): monotonic-clock spans with trace/span
  ids in a bounded ring, exported as Chrome trace-event JSON
  (``to_chrome_trace()``, perfetto-loadable). Disabled by default:
  every instrumentation site costs one branch until ``enable_tracing()``
  (or ``PADDLE_TPU_TRACE=1``). Train step phases (data / forward /
  backward / optimizer / checkpoint) and the serving request lifecycle
  (submit -> queue -> prefill (chunks) -> decode -> finish, preempt,
  adopt) are instrumented; a request's trace id lives on its handle, so
  a token-identical replay on a rebuilt engine links to the original
  request's trace.

The JAX package's third piece, compile attribution (``compile_scope``,
``compile_summary``, ``compiles_by_origin``), waits for the port's AOT
work: the names exist and raise ``NotImplementedError`` (ROADMAP.md,
port queue: runtime services).

CLI: ``tools/torch_obs_dump.py`` (``--json`` | ``--prom`` | ``--trace``).
"""
from . import collectors, metrics, tracing  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, REGISTRY, Counter, Gauge, Histogram,
    MetricsRegistry, counter, gauge, histogram, register_collector,
    snapshot, to_prometheus,
)
from .tracing import (  # noqa: F401
    begin_span, current_trace_id, end_span, instant, new_trace_id,
    span, span_event, spans, to_chrome_trace,
)
from .tracing import enable as enable_tracing  # noqa: F401
from .tracing import disable as disable_tracing  # noqa: F401
from .tracing import enabled as tracing_enabled  # noqa: F401
from .tracing import reset as reset_tracing  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
    "register_collector", "snapshot", "to_prometheus",
    "span", "instant", "span_event", "begin_span", "end_span",
    "new_trace_id", "current_trace_id", "spans", "to_chrome_trace",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "reset_tracing",
]


def _compile_attribution(name):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"observability.{name} (XLA compile attribution) is not in this "
            "slice of the PyTorch port: its analogue, kernel builds and "
            "CUDA-graph captures, comes with the AOT work (ROADMAP.md, port "
            "queue: runtime services)")
    unported.__name__ = name
    return unported


compile_scope = _compile_attribution("compile_scope")
compile_summary = _compile_attribution("compile_summary")
compiles_by_origin = _compile_attribution("compiles_by_origin")

collectors.install_default_collectors()
