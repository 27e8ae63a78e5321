"""Span tracer: monotonic-clock spans with trace/span ids, a bounded
in-process ring, and Chrome trace-event (perfetto-loadable) export.
Counterpart of ``paddle_tpu/observability/tracing.py``: the same API,
span records, id format and export.

Design constraints, in order:

1. **Near-zero overhead when disabled.** Every instrumentation site
   guards on the module flag ``_ENABLED`` (a plain attribute read)
   before building any span machinery, so the disabled path costs one
   branch. ``span()`` itself fast-paths the same way for call sites
   that don't pre-check. The ``train.forward`` and ``train.backward``
   sites are PyTorch's own: while tracing is on, a global module
   forward pre-hook and hook (``torch.nn.modules.module.
   register_module_forward_{pre_,}hook``) open one span per OUTERMOST
   module call, and ``torch.Tensor.backward`` is wrapped; ``disable()``
   removes both, so a disabled tracer leaves torch's call path as it was.
2. **Durations come from ``time.perf_counter()``**, never the wall
   clock. Chrome timestamps are microseconds relative to a process-start
   anchor, which is what perfetto wants.
3. **Bounded.** Completed spans land in a ring (``deque(maxlen=...)``);
   a tracer left enabled for weeks cannot eat the host.
4. **No device synchronisation.** A span is host wall time around the
   work it encloses: around an enqueue of CUDA kernels it ends when the
   launches return, not when the device finishes them (the serving
   decode step's own one device-to-host read is inside its span, so that
   span does cover the step's device time). Device time comes from the
   profiler (``paddle_tpu_torch.profiler``).

Trace ids are process-unique strings minted by :func:`new_trace_id`
(``<pid hex>-<counter hex>``). A span opened inside another span
inherits its trace id (and records the parent span id); detached work
(a serving request whose lifecycle crosses many engine steps, or a
token-identical replay on a rebuilt engine) carries its trace id
explicitly (``span(trace_id=...)``), so a request's queue / prefill /
decode spans link into one trace even across an ``EngineSupervisor``
rebuild. Under tensor parallelism every rank's handle carries rank 0's
id (``serving.Engine._agree``), so the ranks' spans name one trace.

``PADDLE_TPU_TRACE=1`` in the environment turns the tracer on at import.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

__all__ = [
    "enable", "disable", "enabled", "reset", "span", "instant",
    "span_event", "begin_span", "end_span", "new_trace_id",
    "current_trace_id", "spans", "to_chrome_trace", "ring_size",
    "forward_span",
]

_ENABLED = os.environ.get("PADDLE_TPU_TRACE", "0") not in ("0", "", "false")
_RING_SIZE = 8192
_ring = collections.deque(maxlen=_RING_SIZE)
_tls = threading.local()
_ids = itertools.count(1)
_id_lock = threading.Lock()
# Chrome ts anchor: all exported timestamps are perf_counter deltas
# from process start, in microseconds
_T0 = time.perf_counter()
# the torch hooks installed while tracing is on (see _install_hooks)
_HOOKS = None


def new_trace_id():
    """Mint a process-unique trace (or span) id. Cheap enough to call
    unconditionally: request handles carry one whether or not tracing is
    on, so chaos verdicts and ledgers can always reference it."""
    with _id_lock:
        n = next(_ids)
    return f"{os.getpid():x}-{n:x}"


def trace_id_float(trace_id):
    """A trace id as one float, exact in float64 (a pid below 2**22, a
    counter below 2**31): the form a lockstep collective carries it in,
    so a maximum over ranks is one rank's whole id. -inf for None."""
    if trace_id is None:
        return float("-inf")
    pid, n = (int(x, 16) for x in trace_id.split("-"))
    return float(pid << 31 | n)


def trace_id_of(x):
    """The trace id :func:`trace_id_float` made ``x`` of (None for
    -inf)."""
    if x == float("-inf"):
        return None
    x = int(x)
    return f"{x >> 31:x}-{x & (2**31 - 1):x}"


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def enable(ring=None):
    """Turn the tracer on (optionally resizing the ring)."""
    global _ENABLED
    if ring is not None:
        ring_size(ring)
    _ENABLED = True
    _install_hooks()


def disable():
    global _ENABLED
    _ENABLED = False
    _remove_hooks()


def enabled():
    return _ENABLED


def ring_size(n):
    """Resize the completed-span ring (drops current contents)."""
    global _ring, _RING_SIZE
    _RING_SIZE = int(n)
    _ring = collections.deque(maxlen=_RING_SIZE)


def reset():
    """Drop all recorded spans (keeps enabled state and ring size)."""
    _ring.clear()


def current_trace_id():
    """Trace id of the innermost open span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1][1] if st else None


class _SpanToken:
    __slots__ = ("name", "cat", "trace", "span", "parent", "t0", "args")

    def __init__(self, name, cat, trace, span_id, parent, t0, args):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.span = span_id
        self.parent = parent
        self.t0 = t0
        self.args = args


def begin_span(name, cat="", trace_id=None, **attrs):
    """Open a span without a context manager (RecordEvent-style begin/
    end pairs). Returns a token for :func:`end_span`, or None when
    tracing is disabled."""
    if not _ENABLED:
        return None
    st = _stack()
    parent = st[-1] if st else None
    trace = trace_id or (parent[1] if parent else new_trace_id())
    tok = _SpanToken(name, cat, trace, new_trace_id(),
                     parent[0] if parent else None,
                     time.perf_counter(), attrs or None)
    st.append((tok.span, trace))
    return tok


def end_span(tok, **attrs):
    if tok is None:
        return
    st = _stack()
    if st and st[-1][0] == tok.span:
        st.pop()
    else:                      # out-of-order end: drop it if present
        _tls.stack = [s for s in st if s[0] != tok.span]
    if attrs:
        tok.args = dict(tok.args or {}, **attrs)
    _record(tok.name, tok.cat, tok.trace, tok.span, tok.parent,
            tok.t0, time.perf_counter() - tok.t0, tok.args)


@contextlib.contextmanager
def span(name, cat="", trace_id=None, **attrs):
    """Record one span around the with-body. Disabled => one branch."""
    if not _ENABLED:
        yield None
        return
    tok = begin_span(name, cat, trace_id, **attrs)
    try:
        yield tok
    finally:
        end_span(tok)


def instant(name, cat="", trace_id=None, **attrs):
    """Zero-duration marker (Chrome phase "i")."""
    if not _ENABLED:
        return
    st = getattr(_tls, "stack", None)
    parent = st[-1] if st else None
    _record(name, cat, trace_id or (parent[1] if parent else None),
            new_trace_id(), parent[0] if parent else None,
            time.perf_counter(), 0.0, attrs or None, ph="i")


def span_event(name, t0, t1, cat="", trace_id=None, **attrs):
    """Record an already-timed span from two ``perf_counter`` stamps:
    phases whose begin and end live in different calls (a request's
    time in queue, its whole decode phase)."""
    if not _ENABLED:
        return
    _record(name, cat, trace_id, new_trace_id(), None, t0,
            max(0.0, t1 - t0), attrs or None)


class _ForwardSpan:
    """Span for the OUTERMOST module call on this thread: module calls
    inside it enter a shared no-op instead, so a model forward is ONE
    ``train.forward`` span, not one per submodule."""

    __slots__ = ("label", "tok")

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        _tls.in_forward = True
        self.tok = begin_span("train.forward", cat="train",
                              layer=self.label)
        return self.tok

    def __exit__(self, *exc):
        _tls.in_forward = False
        end_span(self.tok)


_NULL_CM = contextlib.nullcontext()


def forward_span(label):
    """A real ``train.forward`` span for the outermost forward on this
    thread, a shared nullcontext for everything else (tracing disabled
    included)."""
    if not _ENABLED or getattr(_tls, "in_forward", False):
        return _NULL_CM
    return _ForwardSpan(label)


# -- the torch hooks (installed only while tracing is on) -------------------

def _fwd_pre(module, args):
    if getattr(_tls, "fwd_owner", None) is not None:
        return
    cm = forward_span(type(module).__name__)
    if cm is _NULL_CM:
        return
    cm.__enter__()
    _tls.fwd_owner = (module, cm)


def _fwd_post(module, args, output):
    owner = getattr(_tls, "fwd_owner", None)
    if owner is not None and owner[0] is module:
        _tls.fwd_owner = None
        owner[1].__exit__(None, None, None)


def _install_hooks():
    """Global module forward hooks (one ``train.forward`` span per
    outermost call of any ``torch.nn.Module``: the port's models and
    ``nn.Layer`` alike) and a ``train.backward`` span around
    ``torch.Tensor.backward``. Idempotent."""
    global _HOOKS
    if _HOOKS is not None:
        return
    import torch
    from torch.nn.modules import module as _module

    _tls.fwd_owner = None
    _tls.in_forward = False
    orig = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        with span("train.backward", cat="train"):
            return orig(self, *args, **kwargs)

    backward.__wrapped__ = orig
    torch.Tensor.backward = backward
    _HOOKS = (_module.register_module_forward_pre_hook(_fwd_pre),
              _module.register_module_forward_hook(_fwd_post,
                                                   always_call=True),
              orig)


def _remove_hooks():
    global _HOOKS
    if _HOOKS is None:
        return
    import torch

    pre, post, orig = _HOOKS
    pre.remove()
    post.remove()
    torch.Tensor.backward = orig
    _HOOKS = None
    _tls.fwd_owner = None
    _tls.in_forward = False


def _record(name, cat, trace, span_id, parent, t0, dur, args, ph="X"):
    _ring.append({
        "name": name, "cat": cat or "span", "ph": ph,
        "trace": trace, "span": span_id, "parent": parent,
        "t0": t0, "dur": dur, "tid": threading.get_ident(),
        "args": args})


def spans(name=None):
    """Completed spans (oldest first), optionally filtered by name."""
    out = list(_ring)
    if name is not None:
        out = [s for s in out if s["name"] == name]
    return out


def to_chrome_trace():
    """Export the ring as a Chrome trace-event JSON document (load in
    perfetto / chrome://tracing). Timestamps are microseconds since
    process start on the monotonic clock."""
    events = [{
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": f"paddle_tpu_torch pid={os.getpid()}"}}]
    for s in sorted(_ring, key=lambda s: s["t0"]):
        args = dict(s["args"] or {})
        if s["trace"]:
            args["trace_id"] = s["trace"]
        if s["parent"]:
            args["parent_span"] = s["parent"]
        ev = {"name": s["name"], "cat": s["cat"], "ph": s["ph"],
              "pid": os.getpid(), "tid": s["tid"],
              "ts": round((s["t0"] - _T0) * 1e6, 3), "args": args}
        if s["ph"] == "X":
            ev["dur"] = round(s["dur"] * 1e6, 3)
        else:
            ev["s"] = "t"      # instant scope: thread
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


if _ENABLED:
    _install_hooks()
