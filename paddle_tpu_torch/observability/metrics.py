"""Typed metrics registry: Counter / Gauge / Histogram with labels.
Counterpart of ``paddle_tpu/observability/metrics.py``: the same
instruments, name checks, JSON snapshot and Prometheus text format 0.0.4.

One process-wide :class:`MetricsRegistry` of typed instruments,
exportable as a JSON snapshot (``snapshot()``) or Prometheus text
exposition (``to_prometheus()``), with the port's existing counter
sources (``serving.metrics.global_counters()`` and the fleet, supervisor
and ledger counters, ``distributed.comm_opt.global_comm_stats()``)
attached as pull-time *collectors* (``collectors.py``), so their hot
paths keep their plain-attribute increments and pay nothing at record
time.

Overhead policy: instruments are mutated only where something already
slow happens (a decode step, a train step, a checkpoint save); scrapes do
the aggregation work. An idle registry costs a dict and some ints.

``Histogram`` supports a count-windowed rolling view for live quantile
queries: ``window=N`` keeps two generations of bucket counts rotated
every ``N // 2`` observations, so ``percentile(p)`` reflects roughly
the last N observations (the serving ITL p50/p95 behind brownout
shedding and ``EngineOverloaded.retry_after_s``) while the exported
cumulative buckets never lose history.
"""
from __future__ import annotations

import bisect
import json
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
    "register_collector", "snapshot", "to_prometheus",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Exponential latency bounds (seconds), 100us .. 10s: wide enough for
#: a CPU decode step and a GPU one.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _check_name(name):
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class _Metric:
    """Shared instrument plumbing: name/help/labels + child table."""

    kind = None

    def __init__(self, name, help="", labelnames=(), registry="default"):
        self.name = _check_name(name)
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self._lock = threading.Lock()
        self._children = {}     # label-value tuple -> child state
        if registry == "default":
            registry = REGISTRY
        if registry is not None:
            registry.register(self)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self.labels()

    def samples(self):
        """[(labels_dict, child_state)] snapshot for export."""
        with self._lock:
            return [(dict(zip(self.labelnames, key)), child)
                    for key, child in sorted(self._children.items())]


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Counter(_Metric):
    """Monotonically increasing value (events, seconds-of-work)."""

    kind = "counter"
    _new_child = _CounterChild

    def inc(self, n=1.0):
        self._unlabeled().inc(n)

    @property
    def value(self):
        with self._lock:
            return sum(c.value for c in self._children.values())


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def inc(self, n=1.0):
        self.value += n

    def dec(self, n=1.0):
        self.value -= n


class Gauge(_Metric):
    """Point-in-time value (queue depth, pool occupancy)."""

    kind = "gauge"
    _new_child = _GaugeChild

    def set(self, v):
        self._unlabeled().set(v)

    def inc(self, n=1.0):
        self._unlabeled().inc(n)

    def dec(self, n=1.0):
        self._unlabeled().dec(n)

    @property
    def value(self):
        with self._lock:
            return sum(c.value for c in self._children.values())


class Histogram:
    """Bucketed distribution with cumulative export and an optional
    count-windowed rolling view for quantiles.

    Unlabeled (label a histogram by creating one per stream and merging
    at collect time — see the serving ITL collector). ``percentile(p)``
    interpolates linearly inside the bucket that holds the rank; with
    ``window=N`` it covers the last ~N observations (two generations
    rotated every ``N // 2``), otherwise the full history.
    """

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_LATENCY_BUCKETS,
                 window=None, registry="default"):
        self.name = _check_name(name)
        self.help = str(help)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("need at least one bucket bound")
        self._lock = threading.Lock()
        n = len(self.bounds) + 1          # last slot: +Inf
        self._counts = [0] * n            # cumulative-forever, for export
        self.sum = 0.0
        self.count = 0
        self.window = None if window is None else max(2, int(window))
        if self.window:
            self._hot = [0] * n
            self._cold = [0] * n
            self._hot_n = 0
        if registry == "default":
            registry = REGISTRY
        if registry is not None:
            registry.register(self)

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.sum += v
            self.count += 1
            if self.window:
                if self._hot_n >= self.window // 2:
                    self._cold = self._hot
                    self._hot = [0] * len(self._counts)
                    self._hot_n = 0
                self._hot[i] += 1
                self._hot_n += 1

    def _view(self):
        if not self.window:
            return self._counts
        return [h + c for h, c in zip(self._hot, self._cold)]

    def percentile(self, p):
        """Approximate percentile (linear interpolation inside the
        owning bucket) over the rolling window when one is configured,
        else over all observations. None before the first observe."""
        with self._lock:
            counts = list(self._view())
        n = sum(counts)
        if n == 0:
            return None
        target = max(1, min(n, p / 100.0 * n))
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[min(i, len(self.bounds) - 1)]
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds[-1]

    def cumulative(self):
        """[(upper_bound, cumulative_count)] + (+Inf, total) for the
        Prometheus exposition (never windowed)."""
        with self._lock:
            out, cum = [], 0
            for b, c in zip(self.bounds, self._counts):
                cum += c
                out.append((b, cum))
            out.append((float("inf"), cum + self._counts[-1]))
            return out

    def merge_counts(self, into):
        """Add this histogram's cumulative per-bucket counts into the
        list ``into`` (same bucket bounds assumed) — collector-side
        aggregation across streams."""
        with self._lock:
            for i, c in enumerate(self._counts):
                into[i] += c
            return self.sum, self.count


class MetricsRegistry:
    """Named instruments + pull-time collectors, one scrape surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []     # (name, fn) -> iterable of families

    def register(self, metric):
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is not None and cur is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def collector(self, fn, name=None):
        """Register a pull-time source: ``fn()`` returns an iterable of
        family dicts (``{"name", "kind", "help", "samples": [(labels,
        value)]}`` or histogram families with ``"buckets"/"sum"/
        "count"``). Re-registering under the same name replaces."""
        name = name or getattr(fn, "__name__", repr(fn))
        with self._lock:
            self._collectors = [(n, f) for n, f in self._collectors
                                if n != name]
            self._collectors.append((name, fn))
        return fn

    # -- scrape ------------------------------------------------------------

    def collect(self):
        """Yield family dicts from every instrument and collector.
        Collector exceptions are captured into a
        ``paddle_collector_errors`` family instead of killing the
        scrape."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            if m.kind == "histogram":
                yield {"name": m.name, "kind": "histogram",
                       "help": m.help, "buckets": m.cumulative(),
                       "sum": m.sum, "count": m.count}
            else:
                yield {"name": m.name, "kind": m.kind, "help": m.help,
                       "samples": [(lbl, child.value)
                                   for lbl, child in m.samples()]}
        errors = []
        for name, fn in collectors:
            try:
                for fam in fn():
                    yield fam
            except Exception as e:
                errors.append((name, f"{type(e).__name__}: {e}"))
        if errors:
            yield {"name": "paddle_collector_errors", "kind": "gauge",
                   "help": "collectors that failed this scrape",
                   "samples": [({"collector": n, "error": msg}, 1.0)
                               for n, msg in errors]}

    def snapshot(self):
        """JSON-serializable snapshot of every family."""
        out = {}
        for fam in self.collect():
            if fam["kind"] == "histogram":
                out[fam["name"]] = {
                    "kind": "histogram", "sum": fam["sum"],
                    "count": fam["count"],
                    "buckets": [[("+Inf" if b == float("inf") else b), c]
                                for b, c in fam["buckets"]]}
            else:
                out[fam["name"]] = {
                    "kind": fam["kind"],
                    "samples": [{"labels": lbl, "value": v}
                                for lbl, v in fam["samples"]]}
        json.dumps(out)       # a non-serializable family is a bug HERE
        return out

    def to_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for fam in self.collect():
            name = fam["name"]
            if fam.get("help"):
                lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            if fam["kind"] == "histogram":
                for b, c in fam["buckets"]:
                    le = "+Inf" if b == float("inf") else _fmt_num(b)
                    lines.append(
                        f'{name}_bucket{{le="{le}"}} {int(c)}')
                lines.append(f"{name}_sum {_fmt_num(fam['sum'])}")
                lines.append(f"{name}_count {int(fam['count'])}")
            else:
                for lbl, v in fam["samples"]:
                    lines.append(f"{name}{_fmt_labels(lbl)} {_fmt_num(v)}")
        return "\n".join(lines) + "\n"


def _esc_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s):
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(lbl):
    if not lbl:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in sorted(
        lbl.items()))
    return "{" + inner + "}"


def _fmt_num(v):
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


#: The process-wide default registry every helper below targets.
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()):
    return Counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return Gauge(name, help, labelnames)


def histogram(name, help="", buckets=DEFAULT_LATENCY_BUCKETS,
              window=None):
    return Histogram(name, help, buckets, window)


def register_collector(fn, name=None):
    return REGISTRY.collector(fn, name)


def snapshot():
    return REGISTRY.snapshot()


def to_prometheus():
    return REGISTRY.to_prometheus()
