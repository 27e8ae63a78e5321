"""The Benchmark tool (reader_cost / batch_cost / ips statistics around
training loops) and its ``benchmark()`` singleton accessor. Counterpart
of ``paddle_tpu/profiler/timer.py`` (reference:
python/paddle/profiler/timer.py), the same host-side bookkeeping.

The DataLoader calls before_reader/after_reader around each fetch (see
io/dataloader.py) and ``Profiler.step()`` / user code calls ``step``:
the reference's call surface; the bookkeeping is a direct timer instead
of the reference's hook/event stack.
"""
from __future__ import annotations

import timeit

__all__ = ["Benchmark", "benchmark"]


class _StepStats:
    def __init__(self):
        self.reset()

    def reset(self):
        self.reader_total = 0.0
        self.batch_total = 0.0
        self.steps = 0
        self.samples = 0

    def reader_average(self):
        return self.reader_total / self.steps if self.steps else 0.0

    def batch_average(self):
        return self.batch_total / self.steps if self.steps else 0.0


class Benchmark:
    """Statistics of model performance (reference timer.py:319).

    ``before_reader``/``after_reader`` bracket each DataLoader fetch;
    ``begin``/``step``/``end`` bracket steps. ``step_info(unit)``
    formats the current averages and resets them.
    """

    def __init__(self):
        self.num_samples = None
        self.speed_mode = "samples/s"
        self._stats = _StepStats()
        self._reader_t0 = None
        self._step_t0 = None
        self._recording = False
        self._reader_owner = None  # id() of the loader whose fetches count

    # -- lifecycle -------------------------------------------------------
    def begin(self):
        self._stats.reset()
        self._recording = True
        self._step_t0 = timeit.default_timer()

    def step(self, num_samples=None):
        """Record the current step (called by Profiler.step or the
        training loop)."""
        self.num_samples = num_samples
        if not self._recording:
            return
        now = timeit.default_timer()
        if self._step_t0 is not None:
            self._stats.batch_total += now - self._step_t0
            self._stats.steps += 1
            if num_samples:
                self._stats.samples += int(num_samples)
        self._step_t0 = now

    def end(self):
        self._recording = False

    # -- DataLoader integration -----------------------------------------
    def before_reader(self, owner=None):
        if self._reader_owner is not None and owner is not None \
                and owner != self._reader_owner:
            return  # a nested/other loader (e.g. eval inside train)
        self._reader_t0 = timeit.default_timer()

    def after_reader(self, owner=None):
        if self._reader_owner is not None and owner is not None \
                and owner != self._reader_owner:
            return
        if self._recording and self._reader_t0 is not None:
            self._stats.reader_total += \
                timeit.default_timer() - self._reader_t0
        self._reader_t0 = None

    def check_if_need_record(self, reader):
        """First loader to iterate while recording owns reader timing
        (reference Benchmark.check_if_need_record pauses the timer when
        a different task's loader starts, e.g. eval inside train)."""
        if self._recording and self._reader_owner is None:
            self._reader_owner = id(reader)

    def release_reader(self, reader):
        if self._reader_owner == id(reader):
            self._reader_owner = None

    # -- reporting -------------------------------------------------------
    def step_info(self, unit="samples"):
        s = self._stats
        message = ""
        if s.reader_total:
            message += f" reader_cost: {s.reader_average():.5f} s"
        batch_avg = s.batch_average()
        if batch_avg:
            message += f" batch_cost: {batch_avg:.5f} s"
            if s.samples:
                ips = s.samples / s.batch_total
                message += f" ips: {ips:.3f} {unit}/s"
            elif s.steps:
                message += f" ips: {s.steps / s.batch_total:.3f} steps/s"
        s.reset()
        return message


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    """The process-wide Benchmark singleton (reference timer.py:411)."""
    return _benchmark
