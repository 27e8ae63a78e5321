"""Process-unique trace ids: ``observability.tracing.new_trace_id``
re-exported, ids in its ``<pid hex>-<counter hex>`` format. Request
handles and chaos faults carry one whether or not tracing is on, so
ledgers and chaos verdicts can link a fault to the requests it hit.
"""
from ..observability.tracing import new_trace_id

__all__ = ["new_trace_id"]
