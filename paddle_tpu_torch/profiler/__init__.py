"""Profiler: the paddle.profiler API over ``torch.profiler``. Counterpart
of ``paddle_tpu/profiler`` (reference: python/paddle/profiler/
profiler.py and utils.py).

``Profiler`` brackets a ``torch.profiler.profile`` recording window
(``make_scheduler``'s RECORD states) with its targets' activities:
``ProfilerTarget.CPU`` the host operators and user ranges,
``ProfilerTarget.GPU`` (Kineto with CUPTI) the CUDA runtime calls and
every device kernel, the ``ctypes``-launched kernels of ``csrc/`` among
them under their ``__global__`` names. A closed window is exported as Chrome
trace-event JSON (``<worker>.pt.trace.json``, perfetto-loadable) into the
profiler's directory, or wherever ``on_trace_ready`` puts it
(``export_chrome_tracing(dir)``); ``load_profiler_result`` reads it back
and ``summary()`` prints its tables. A GPU target on a machine whose
torch has no CUDA activity (no CUDA, or no CUPTI) raises: the profiler
never quietly returns a host-only profile.

``RecordEvent`` is ``torch.profiler.record_function`` and, while the
observability tracer is on, a ``user::<name>`` span in its ring.
The counter functions and the summary's ``serving:``, ``resilience:``,
``fleet:``, ``serving-resilience:`` and ``comm:`` lines read the port's
live engines, ledgers, fleets, supervisors and comm-opt steps.
``dispatch_counters`` and ``aot_counters`` have no source in the port
yet and raise (ROADMAP.md, port queue item 9 and runtime services).
"""
from __future__ import annotations

import functools
import os
import socket
import time
from enum import Enum
from typing import Callable, Iterable, Optional

from .timer import Benchmark, benchmark  # noqa: F401

__all__ = [
    "Benchmark", "benchmark", "dispatch_counters", "serving_counters",
    "resilience_counters", "serving_resilience_counters", "aot_counters",
    "fleet_counters",
    "ProfilerState", "ProfilerTarget",
    "make_scheduler", "export_chrome_tracing", "export_protobuf",
    "Profiler", "RecordEvent", "RecordInstantEvent",
    "load_profiler_result", "SortedKeys",
]


def _unported(what, item):
    return NotImplementedError(
        f"profiler.{what} is not in this slice of the PyTorch port "
        f"(ROADMAP.md, port queue: {item})")


def dispatch_counters() -> dict:
    """The JAX package's eager dispatch-cache counters: the port has no
    dispatch cache (its eager ops are torch's)."""
    raise _unported("dispatch_counters", "item 9")


def aot_counters() -> dict:
    """The JAX package's AOT compile-service snapshot: the port has no AOT
    service yet."""
    raise _unported("aot_counters", "runtime services")


def serving_counters() -> dict:
    """Serving-engine counters summed across every live
    ``serving.Engine`` (requests, tokens, prefills, decode steps, queue
    pressure)."""
    from ..serving import metrics as serving_metrics

    return serving_metrics.global_counters()


def resilience_counters() -> dict:
    """Flight-ledger event counts across every live train-scope ledger
    (steps, anomalies, saves, restores, rollbacks, aborts). Serving-side
    supervisors keep their own ledgers: see
    :func:`serving_resilience_counters`."""
    from ..resilience import ledger as resilience_ledger

    return resilience_ledger.global_counters(scope="train")


def serving_resilience_counters() -> dict:
    """Engine-supervisor counters across every live
    ``serving.EngineSupervisor`` (rebuilds, token-identical replays,
    wedges, KV corruptions, brownout sheds, drains)."""
    from ..serving import resilience as serving_resilience

    return serving_resilience.global_counters()


def fleet_counters() -> dict:
    """Replica-fleet counters across every live ``serving.ReplicaFleet``
    (routing decisions and prefix hits, migrations, failovers, replica
    health states)."""
    from ..serving import fleet as serving_fleet

    return serving_fleet.global_counters()


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-phase scheduler, the reference's semantics."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def _worker_name(worker_name=None):
    return worker_name or f"{socket.gethostname()}_{os.getpid()}"


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready handler: write each closed recording window as
    ``<dir_name>/<worker_name>.pt.trace.json`` (the default worker name is
    ``<host>_<pid>``)."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        prof._export_dir = dir_name
        prof.export(os.path.join(
            dir_name, f"{_worker_name(worker_name)}.pt.trace.json"))
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """The reference's protobuf export; here the same Chrome trace."""
    return export_chrome_tracing(dir_name, worker_name)


#: live started-but-not-stopped Profiler count: utils.in_profiler_mode
_ACTIVE_PROFILERS = 0


def _activities(targets):
    """The ``torch.profiler`` activities of ``targets`` (CPU: the host's
    operators and user ranges; GPU: CUDA's runtime calls and kernels);
    raises for a GPU target whose CUDA activity this torch cannot
    record."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            if not torch.cuda.is_available() or \
                    ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError(
                    "ProfilerTarget.GPU: this torch cannot record CUDA "
                    "activity (no CUDA device, or no CUPTI); profile with "
                    "targets=[ProfilerTarget.CPU] for a host-only profile")
            acts.append(ProfilerActivity.CUDA)
        elif t in (ProfilerTarget.TPU, ProfilerTarget.CUSTOM_DEVICE):
            raise ValueError(f"{t}: the PyTorch port profiles the CPU and "
                             "CUDA devices")
    if not acts:
        raise ValueError("Profiler: no target to profile")
    return acts


#: CUPTI_ACTIVITY_FLAG_FLUSH_FORCED (cupti_activity.h)
_CUPTI_FLUSH_FORCED = 1
#: seconds between the two flushes
_SETTLE_S = 1.0


def _flush_device_records():
    """Waits for the device and hands CUPTI's pending kernel records to the
    recording window before it closes. Without it a window on an H100
    (torch 2.11, CUDA 12.8) could lack the records of a run of kernels
    near its end; ``tools/torch_profile_check.py`` counts them with and
    without this. It forces a flush through the CUPTI that
    ``torch.profiler`` already loaded, waits ``_SETTLE_S`` for CUPTI to
    finish the device's buffers, and forces another; where no CUPTI is
    loaded under its usual names it only waits."""
    import ctypes

    import torch

    torch.cuda.synchronize()
    lib = None
    for name in ("libcupti.so.12", "libcupti.so.13", "libcupti.so"):
        try:
            lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD)
            break
        except OSError:
            continue
    if lib is not None:
        lib.cuptiActivityFlushAll(_CUPTI_FLUSH_FORCED)
    time.sleep(_SETTLE_S)
    if lib is not None:
        lib.cuptiActivityFlushAll(_CUPTI_FLUSH_FORCED)


class Profiler:
    """paddle.profiler.Profiler over ``torch.profiler``.

    Usage matches the reference::

        with profiler.Profiler(targets=[...], on_trace_ready=...) as p:
            for step ...: train(); p.step()
        p.summary()

    ``targets`` defaults to the CPU, and the GPU when CUDA is available.
    ``scheduler`` is a ``make_scheduler`` function or a ``(lo, hi)`` step
    range; ``timer_only`` records step times only (no trace).
    """

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready=None, timer_only=False,
                 record_shapes=False, profile_memory=False,
                 with_flops=False):
        if targets is None:
            import torch
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        self.targets = list(targets)
        self._acts = None if timer_only else _activities(self.targets)
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=max(0, lo), ready=0,
                                            record=hi - lo, repeat=1)
        else:
            self.scheduler = scheduler or _default_scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self._opts = dict(record_shapes=record_shapes,
                          profile_memory=profile_memory,
                          with_flops=with_flops)
        self._export_dir = os.path.join("profiler_log",
                                        time.strftime("%Y%m%d_%H%M%S"))
        self.current_state = ProfilerState.CLOSED
        self._prof = None          # the open torch.profiler window
        self._last = None          # the last closed one
        self._step = 0
        self._step_times = []
        self._t0 = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        global _ACTIVE_PROFILERS
        _ACTIVE_PROFILERS += 1
        self.current_state = self.scheduler(self._step)
        self._maybe_toggle()
        self._t0 = time.perf_counter()
        benchmark().begin()  # reader_cost/ips collection (timer.py)
        return self

    def stop(self):
        global _ACTIVE_PROFILERS
        _ACTIVE_PROFILERS = max(0, _ACTIVE_PROFILERS - 1)
        if self._prof is not None:
            self._close_window()
        self.current_state = ProfilerState.CLOSED
        benchmark().end()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._t0 is not None:
            self._step_times.append(now - self._t0)
        self._t0 = now
        self._step += 1
        benchmark().step(num_samples)  # reference Profiler.step drives it
        self.current_state = self.scheduler(self._step)
        self._maybe_toggle()

    def _maybe_toggle(self):
        want = self.current_state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)
        if want and self._prof is None and not self.timer_only:
            import torch

            self._prof = torch.profiler.profile(activities=self._acts,
                                                **self._opts)
            self._prof.__enter__()
        elif not want and self._prof is not None:
            self._close_window()

    def _close_window(self):
        """End the recording window (``torch.profiler`` waits for the
        device's pending work) and hand the trace on: to
        ``on_trace_ready``, or into the profiler's directory."""
        prof, self._prof = self._prof, None
        if ProfilerTarget.GPU in self.targets:
            _flush_device_records()
        prof.__exit__(None, None, None)
        self._last = prof
        if self.on_trace_ready:
            self.on_trace_ready(self)
        else:
            os.makedirs(self._export_dir, exist_ok=True)
            self.export(os.path.join(
                self._export_dir, f"{_worker_name()}.pt.trace.json"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- reporting -----------------------------------------------------------

    def step_info(self, unit=None) -> str:
        """Step-time stats plus the Benchmark's reader_cost/batch_cost/
        ips line (reference profiler.py Profiler.step_info)."""
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        t = np.asarray(self._step_times)
        bench = benchmark().step_info(unit or "samples")
        return (f"steps: {len(t)}  avg: {t.mean()*1e3:.2f} ms  "
                f"min: {t.min()*1e3:.2f} ms  max: {t.max()*1e3:.2f} ms"
                + (f" |{bench}" if bench else ""))

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        print(self.step_info())
        for line in counter_lines():
            print(line)
        from ..observability import tracing as _trc
        if _trc.enabled() and _trc.spans():
            from .profiler_statistic import build_span_summary
            print(build_span_summary(sorted_by=sorted_by,
                                     time_unit=time_unit))
        if self.timer_only:
            return
        try:
            from .statistic import build_summary, load_profiler_result
            result = load_profiler_result(self._export_dir)
            print(build_summary(result, sorted_by=sorted_by,
                                time_unit=time_unit))
        except (FileNotFoundError, ValueError, OSError, EOFError):
            # no recorded window, or a truncated/corrupt exported trace:
            # degrade to the trace-dir message
            pass
        print(f"trace dir: {self._export_dir} (perfetto or "
              f"chrome://tracing)")

    def export(self, path: str, format: str = "json"):
        """Write the last closed window as Chrome trace JSON."""
        if self._last is None:
            raise RuntimeError("no recording window has closed yet")
        self._last.export_chrome_trace(path)
        return path


def counter_lines():
    """The summary's counter lines (the JAX package's formats): serving
    engines, train ledgers, fleets, engine supervisors and comm-opt
    steps, each only when it has a live source."""
    out = []
    sc = serving_counters()
    if sc["engines"]:
        hr = sc.get("prefix_hit_rate")
        lw = sc.get("pool_low_watermark")
        out.append(
            "serving: "
            f"engines={sc['engines']} "
            f"requests={sc['requests_completed']}/"
            f"{sc['requests_submitted']} "
            f"tokens={sc['tokens_generated']} "
            f"prefills={sc['prefills']} "
            f"decode_steps={sc['decode_steps']} "
            f"peak_queue={sc['peak_queue_depth']} "
            f"peak_active={sc.get('peak_active', 0)} "
            f"prefix_hit_rate={'-' if hr is None else hr} "
            f"cow={sc.get('cow_copies', 0)} "
            f"preempt={sc.get('preemptions', 0)} "
            f"chunk_steps={sc.get('chunk_steps', 0)} "
            f"pool_low_watermark={'-' if lw is None else lw}"
            + (f" tp={sc['tp_max']}" if sc.get("tp_max", 1) > 1 else ""))
    rc = resilience_counters()
    if rc["ledgers"]:
        out.append(
            "resilience: "
            f"ledgers={rc['ledgers']} "
            f"steps={rc.get('step', 0)} "
            f"anomalies={rc.get('anomaly', 0)} "
            f"saves={rc.get('save', 0)} "
            f"restores={rc.get('resume', 0)} "
            f"rollbacks={rc.get('rollback', 0)} "
            f"aborts={rc.get('abort', 0)}")
    fc = fleet_counters()
    if fc["fleets"]:
        out.append(
            "fleet: "
            f"fleets={fc['fleets']} "
            f"replicas={fc['replicas']} "
            f"healthy={fc['healthy']} "
            f"degraded={fc['degraded']} "
            f"draining={fc['draining']} "
            f"condemned={fc['condemned']} "
            f"routed={fc['routed']} "
            f"prefix_routed={fc['prefix_routed']} "
            f"migrations={fc['migrations']} "
            f"failovers={fc['failovers']} "
            f"kills={fc['replica_kills']} "
            f"sheds={fc['fleet_sheds']} "
            f"backoffs={fc['backoffs']}")
    sv = serving_resilience_counters()
    if sv["supervisors"]:
        out.append(
            "serving-resilience: "
            f"supervisors={sv['supervisors']} "
            f"rebuilds={sv['rebuilds']} "
            f"replayed={sv['replayed']} "
            f"wedges={sv['wedges']} "
            f"step_errors={sv['step_errors']} "
            f"kv_corruptions={sv['kv_corruptions']} "
            f"shed={sv['shed']} "
            f"abandoned={sv['abandoned']} "
            f"drains={sv['drains']}")
    from ..distributed.comm_opt import global_comm_stats
    cg = global_comm_stats()
    if cg["steps"]:
        arms = " ".join(
            f"[{a['grad_compress'] or 'exact'}"
            f"{'+zero1' if a['zero1'] else ''}"
            + (f" tp={a['tp']}" if a['tp'] > 1 else "")
            + f" ratio={a['compression_ratio']}x"
            f" {a['exchange_bytes_per_step']}B/step"
            f" steps={a['steps']}]"
            for a in cg["arms"])
        out.append(f"comm: arms={cg['steps']} "
                   f"steps={cg['total_steps_run']} {arms}")
    return out


class RecordEvent:
    """A custom named range: ``torch.profiler.record_function(name)`` (in
    the trace of an open recording window) AND, while the observability
    tracer is on, a ``user::<name>`` span in its ring, so RecordEvent
    works without a profiler too."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._span_tok = None

    def begin(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        from ..observability import tracing as _trc
        if _trc.enabled():
            self._span_tok = _trc.begin_span(f"user::{self.name}",
                                             cat="user")

    def end(self):
        if self._span_tok is not None:
            from ..observability import tracing as _trc
            _trc.end_span(self._span_tok)
            self._span_tok = None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapper


class RecordInstantEvent(RecordEvent):
    """Zero-duration marker: an instant in the observability ring plus a
    degenerate ``record_function`` range in the trace."""

    def begin(self):
        from ..observability import tracing as _trc
        _trc.instant(f"user::{self.name}", cat="user")
        import torch

        with torch.profiler.record_function(self.name):
            pass

    def end(self):
        pass


from .statistic import (ProfilerResult, build_summary,  # noqa: E402,F401
                        load_profiler_result)


class SortedKeys(Enum):
    """Sort order for summary tables (reference
    profiler/profiler_statistic.py SortedKeys)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7
