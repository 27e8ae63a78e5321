"""Process-unique trace ids. Counterpart of
``paddle_tpu/observability/tracing.py:new_trace_id``, the same format
(``<pid hex>-<counter hex>``).

Request handles and chaos faults carry one, so ledgers and chaos verdicts
can link a fault to the requests it hit. The port emits no spans (tracing
is port queue item 8): the ids are minted without them.
"""
from __future__ import annotations

import itertools
import os
import threading

__all__ = ["new_trace_id"]

_ids = itertools.count(1)
_lock = threading.Lock()


def new_trace_id():
    """Mint a process-unique trace id."""
    with _lock:
        n = next(_ids)
    return f"{os.getpid():x}-{n:x}"
