"""Profiler statistics: summary tables parsed from the port's exported
Chrome traces. Counterpart of ``paddle_tpu/profiler/statistic.py``
(reference: python/paddle/profiler/profiler_statistic.py).

``torch.profiler`` (Kineto, with CUPTI for the device) records host
operators, user ranges (``RecordEvent`` -> ``record_function``), CUDA
runtime calls and the device's kernels, and ``Profiler`` exports them as
Chrome trace-event JSON (``*.pt.trace.json``). This module reads such a
file back and aggregates it into the reference's summary shapes: a
device summary (busy time per device over the traced span), a kernel
summary grouped by each kernel's ``__global__`` name (template arguments
and parameter lists dropped, so every instantiation of
``flash_decode_split_kernel<...>`` counts as one kernel), the operator
summary of host ops, and the user-range summary. The kernels of
``csrc/`` are launched through ``ctypes``, outside PyTorch's dispatcher:
CUPTI sees them all the same, under their ``__global__`` names.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List

# trace categories -> the kind each event is aggregated under
_KIND_OF_CAT = {
    "kernel": "kernel", "gpu_memcpy": "kernel", "gpu_memset": "kernel",
    "cpu_op": "op", "user_annotation": "annotation",
    "gpu_user_annotation": "annotation",
}


class EventRecord:
    __slots__ = ("name", "pid", "tid", "start_us", "dur_us", "process",
                 "kind")

    def __init__(self, name, pid, tid, start_us, dur_us, process, kind):
        self.name = name
        self.pid = pid
        self.tid = tid
        self.start_us = start_us
        self.dur_us = dur_us
        self.process = process  # the trace's process name, e.g. "GPU 0"
        self.kind = kind        # "kernel" | "op" | "annotation" | "infra"

    def __repr__(self):
        return (f"EventRecord({self.name!r}, {self.kind}, "
                f"{self.dur_us:.1f}us)")


def _drop_last_group(s: str, open_: str, close: str) -> str:
    """``s`` without its trailing balanced ``open_ ... close`` group."""
    if not s.endswith(close):
        return s
    depth = 0
    for i in range(len(s) - 1, -1, -1):
        if s[i] == close:
            depth += 1
        elif s[i] == open_:
            depth -= 1
            if depth == 0:
                return s[:i].rstrip()
    return s


def kernel_name(raw: str) -> str:
    """A device kernel's ``__global__`` name from the demangled signature
    CUPTI reports: ``void (anonymous namespace)::k<__nv_bfloat16, 128,
    1>(float const*, int)`` -> ``k`` (the parameter list, the template
    arguments, the scopes and the return type dropped)."""
    s = _drop_last_group(raw.strip(), "(", ")")
    s = _drop_last_group(s, "<", ">")
    return s.rsplit("::", 1)[-1].rsplit(" ", 1)[-1] or raw


class _Agg:
    __slots__ = ("calls", "total", "mx", "mn")

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.mx = 0.0
        self.mn = float("inf")

    def add(self, dur):
        self.calls += 1
        self.total += dur
        self.mx = max(self.mx, dur)
        self.mn = min(self.mn, dur)

    @property
    def avg(self):
        return self.total / self.calls if self.calls else 0.0

    def as_dict(self):
        return {"calls": self.calls, "total": self.total, "avg": self.avg,
                "max": self.mx, "min": self.mn}


class ProfilerResult:
    """Parsed trace: events plus the reference's aggregate views."""

    def __init__(self, events: List[EventRecord], source: str = ""):
        self.events = events
        self.source = source

    # -- construction -------------------------------------------------------

    @classmethod
    def from_chrome_trace(cls, path: str) -> "ProfilerResult":
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            doc = json.load(fh)
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        processes: Dict[object, str] = {}
        for e in evs:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                processes[e.get("pid")] = e.get("args", {}).get("name", "")
        events = []
        for e in evs:
            if e.get("ph") != "X":
                continue
            kind = _KIND_OF_CAT.get(e.get("cat", ""), "infra")
            name = e.get("name", "")
            if kind == "kernel" and e.get("cat") == "kernel":
                name = kernel_name(name)
            events.append(EventRecord(
                name=name, pid=e.get("pid"), tid=e.get("tid"),
                start_us=float(e.get("ts", 0.0)),
                dur_us=float(e.get("dur", 0.0)),
                process=processes.get(e.get("pid"), str(e.get("pid"))),
                kind=kind))
        return cls(events, source=path)

    @classmethod
    def from_trace_dir(cls, dir_name: str) -> "ProfilerResult":
        for pat in ("*.pt.trace.json", "*.pt.trace.json.gz", "*.json",
                    "*.json.gz"):
            hits = sorted(glob.glob(os.path.join(dir_name, pat)),
                          key=os.path.getmtime)
            if hits:
                return cls.from_chrome_trace(hits[-1])   # latest run
        raise FileNotFoundError(
            f"no chrome trace found under {dir_name!r} (expected "
            "<worker>.pt.trace.json: did the profiler record at least one "
            "step?)")

    # -- aggregate views ----------------------------------------------------

    def _aggregate(self, kind: str) -> Dict[str, dict]:
        out: Dict[str, _Agg] = {}
        for ev in self.events:
            if ev.kind == kind:
                out.setdefault(ev.name, _Agg()).add(ev.dur_us)
        return {k: a.as_dict() for k, a in out.items()}

    def kernel_summary(self) -> Dict[str, dict]:
        """``__global__`` name -> {calls,total,avg,max,min} (microseconds)
        of the device's kernels, copies and sets."""
        return self._aggregate("kernel")

    def op_summary(self) -> Dict[str, dict]:
        """Host operator name -> {calls,total,avg,max,min} (microseconds):
        the reference's Operator Summary."""
        return self._aggregate("op")

    def annotation_summary(self) -> Dict[str, dict]:
        """User ranges (``RecordEvent``, ``record_function``)."""
        return self._aggregate("annotation")

    def device_summary(self) -> Dict[str, float]:
        """Device process name -> busy microseconds of its kernels."""
        out: Dict[str, float] = {}
        for ev in self.events:
            if ev.kind == "kernel":
                out[ev.process] = out.get(ev.process, 0.0) + ev.dur_us
        return out

    def time_range(self) -> float:
        xs = [e for e in self.events if e.dur_us > 0]
        if not xs:
            return 0.0
        lo = min(e.start_us for e in xs)
        hi = max(e.start_us + e.dur_us for e in xs)
        return hi - lo


_UNIT_DIV = {"s": 1e6, "ms": 1e3, "us": 1.0, "ns": 1e-3}

_SORT_FIELD = {  # SortedKeys -> aggregate field
    "CPUTotal": "total", "CPUAvg": "avg", "CPUMax": "max", "CPUMin": "min",
    "GPUTotal": "total", "GPUAvg": "avg", "GPUMax": "max", "GPUMin": "min",
}


def _fmt_table(title: str, rows: List[tuple], unit: str) -> str:
    div = _UNIT_DIV.get(unit, 1e3)
    header = (f"{'Name':<44} {'Calls':>6} {f'Total({unit})':>12} "
              f"{f'Avg({unit})':>10} {f'Max({unit})':>10} "
              f"{f'Min({unit})':>10}")
    bar = "-" * len(header)
    lines = [bar, title, bar, header, bar]
    for name, st in rows:
        nm = name if len(name) <= 43 else name[:40] + "..."
        lines.append(
            f"{nm:<44} {st['calls']:>6} {st['total'] / div:>12.3f} "
            f"{st['avg'] / div:>10.3f} {st['max'] / div:>10.3f} "
            f"{st['min'] / div:>10.3f}")
    lines.append(bar)
    return "\n".join(lines)


def build_summary(result: ProfilerResult, sorted_by=None,
                  time_unit: str = "ms") -> str:
    """Format the reference's summary tables from a parsed trace."""
    field = _SORT_FIELD.get(
        getattr(sorted_by, "name", str(sorted_by)), "total")
    parts = []
    dev = result.device_summary()
    if dev:
        div = _UNIT_DIV.get(time_unit, 1e3)
        span = result.time_range() / div
        lines = ["Device Summary:"]
        for proc, busy in sorted(dev.items()):
            lines.append(f"  {proc or '<unknown>'}: busy "
                         f"{busy / div:.3f}{time_unit} over a "
                         f"{span:.3f}{time_unit} span")
        parts.append("\n".join(lines))
    for title, rows in (("Kernel Summary", result.kernel_summary()),
                        ("Operator Summary", result.op_summary())):
        rows = sorted(rows.items(), key=lambda kv: kv[1][field],
                      reverse=True)
        if rows:
            parts.append(_fmt_table(f"{title} (sorted by {field})",
                                    rows[:40], time_unit))
    anns = sorted(result.annotation_summary().items(),
                  key=lambda kv: kv[1]["total"], reverse=True)
    if anns:
        parts.append(_fmt_table("UserDefined Summary", anns[:20],
                                time_unit))
    return "\n\n".join(parts) if parts else "no events parsed"


def load_profiler_result(filename: str) -> ProfilerResult:
    """Load an exported trace: a profiler output dir or a chrome-trace
    json(.gz) file (reference profiler.py:load_profiler_result)."""
    if os.path.isdir(filename):
        return ProfilerResult.from_trace_dir(filename)
    if not os.path.exists(filename):
        raise FileNotFoundError(
            f"no chrome trace at {filename!r} (pass the profiler's "
            "output dir or a *.pt.trace.json file)")
    return ProfilerResult.from_chrome_trace(filename)
