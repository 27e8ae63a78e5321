"""Latency/throughput ledger for the serving engine.

Counterpart of ``paddle_tpu/serving/metrics.py``: per request TTFT
(submit -> first token out of prefill), inter-token latencies and
tokens/sec; per engine, slot occupancy and queue depth sampled every
step, admission/eviction counters, the speculative-decoding ledger
(verify and draft steps, proposed/accepted/emitted tokens) and the
per-emitted-token ITL histogram. Live engines register in a module-wide
weakref list, so ``global_counters()`` sums their snapshots (the
supervisor, the fleet, the profiler's ``serving:`` line and the
observability registry's ``serving`` collector read it). The ITL
histogram is ``observability.metrics.Histogram``: its rolling window
drives the live p50/p95, its cumulative buckets export through the
registry's merged ``paddle_serving_itl_seconds`` family.

Host clock only: a decode step's wall time ends at the engine's one
device->host read of the sampled tokens, so on the GPU it includes the
step's device time.
"""
from __future__ import annotations

import time
import weakref

from ..observability.metrics import Histogram


def _percentile(values, p):
    """Linear-interpolation percentile (matches numpy 'linear')."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    k = (len(vals) - 1) * (p / 100.0)
    lo = int(k)
    hi = min(lo + 1, len(vals) - 1)
    return float(vals[lo] + (vals[hi] - vals[lo]) * (k - lo))


class RequestMetrics:
    """Timing ledger of one request (wall-clock, perf_counter based)."""

    def __init__(self):
        self.submit_time = time.perf_counter()
        self.first_token_time = None
        self.finish_time = None
        self.token_times = []          # one stamp per emitted token

    def mark_token(self):
        now = time.perf_counter()
        if self.first_token_time is None:
            self.first_token_time = now
        self.token_times.append(now)

    def mark_finished(self):
        self.finish_time = time.perf_counter()

    @property
    def n_tokens(self):
        return len(self.token_times)

    @property
    def ttft(self):
        """Time to first token (seconds), None until the first token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def inter_token_latencies(self):
        t = self.token_times
        return [b - a for a, b in zip(t, t[1:])]

    @property
    def tokens_per_sec(self):
        """Tokens over submit -> finish wall time; None until finished."""
        if self.finish_time is None or not self.token_times:
            return None
        dt = self.finish_time - self.submit_time
        return self.n_tokens / dt if dt > 0 else float("inf")


class EngineMetrics:
    """Aggregate counters for one Engine; registered in the module-wide
    list that ``global_counters()`` sums."""

    def __init__(self):
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self.requests_cancelled = 0
        self.requests_shed = 0
        self.tokens_generated = 0
        self.prefills = 0
        self.decode_steps = 0
        self.occupancy_sum = 0.0       # sum over steps of active/n_slots
        self.queue_depth_sum = 0
        self.peak_queue_depth = 0
        self.samples = 0
        self.peak_active = 0           # max concurrently admitted
        self.preemptions = 0           # pool-exhaustion evict+replay
        self.chunked_prefills = 0      # requests that prefilled chunked
        self.chunk_steps = 0           # chunk-program invocations
        self.prefix_hit_tokens = 0     # prompt tokens served from radix
        self.prompt_tokens = 0         # total prompt tokens admitted
        self.cow_copies = 0            # partial tail blocks privatized
        self.pool_occupancy_sum = 0.0  # used/total blocks per sample
        self.pool_samples = 0
        self.pool_low_watermark = None  # min free blocks ever seen
        # speculative decoding (zero on non-speculative engines): verify
        # calls, fused draft-decode steps, and the proposed / accepted /
        # emitted token ledger behind acceptance_rate
        self.spec_steps = 0
        self.draft_steps = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_emitted_tokens = 0
        # decode-step wall times: the ~64-observation rolling window
        # drives the live ITL p50/p95 behind EngineOverloaded.retry_after_s
        self.itl_hist = Histogram("serving_itl_seconds_local",
                                  window=64, registry=None)
        # fleet identity (stamped by the engine; None standalone)
        self.replica = None
        # tp geometry (stamped by the engine; tp=1 on a single rank)
        self.tp = 1
        self.kv_pool_bytes_per_device = None
        self.collectives_per_decode_step = None
        _register(self)

    def sample(self, occupancy, queue_depth, active=0, pool_free=None,
               pool_total=None):
        self.samples += 1
        self.occupancy_sum += occupancy
        self.queue_depth_sum += queue_depth
        self.peak_queue_depth = max(self.peak_queue_depth, queue_depth)
        self.peak_active = max(self.peak_active, int(active))
        if pool_total:
            self.pool_samples += 1
            self.pool_occupancy_sum += 1.0 - pool_free / pool_total
            self.pool_low_watermark = (
                pool_free if self.pool_low_watermark is None
                else min(self.pool_low_watermark, pool_free))

    def prefix_hit_rate(self):
        """Fraction of admitted prompt tokens served out of the radix
        prefix index; None before any admission."""
        if not self.prompt_tokens:
            return None
        return self.prefix_hit_tokens / self.prompt_tokens

    def mark_decode(self, duration_s, tokens=1):
        """Record one target-model step (a fused decode step or a
        speculative verify) that emitted ``tokens`` tokens per request in
        it: the ITL histogram takes ``tokens`` intervals of ``duration_s
        / tokens``, so its percentiles stay per emitted token (and at
        ``tokens=1`` are what they were before speculation)."""
        self.decode_steps += 1
        n = max(int(tokens), 1)
        per = duration_s / n
        for _ in range(n):
            self.itl_hist.observe(per)

    def acceptance_rate(self):
        """Fraction of proposed draft tokens the verify accepted; None
        before any speculative step."""
        if not self.spec_proposed_tokens:
            return None
        return self.spec_accepted_tokens / self.spec_proposed_tokens

    def itl_estimate(self):
        """Rolling-window median decode-step wall time (seconds), None
        before the first decode."""
        return self.itl_hist.percentile(50)

    def itl_p95(self):
        """p95 of the rolling decode-step window (seconds), the basis of
        ``EngineOverloaded.retry_after_s``; None before the first step."""
        return self.itl_hist.percentile(95)

    def snapshot(self):
        n = max(self.samples, 1)
        itl = self.itl_estimate()
        p95 = self.itl_p95()
        hr = self.prefix_hit_rate()
        ar = self.acceptance_rate()
        return {
            "spec_steps": self.spec_steps,
            "draft_steps": self.draft_steps,
            "spec_proposed_tokens": self.spec_proposed_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_emitted_tokens": self.spec_emitted_tokens,
            "spec_acceptance_rate": (None if ar is None
                                     else round(ar, 4)),
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_shed": self.requests_shed,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "avg_slot_occupancy": round(self.occupancy_sum / n, 4),
            "avg_queue_depth": round(self.queue_depth_sum / n, 4),
            "peak_queue_depth": self.peak_queue_depth,
            "peak_active": self.peak_active,
            "preemptions": self.preemptions,
            "chunked_prefills": self.chunked_prefills,
            "chunk_steps": self.chunk_steps,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_rate": (None if hr is None else round(hr, 4)),
            "cow_copies": self.cow_copies,
            "pool_occupancy": (
                None if not self.pool_samples
                else round(self.pool_occupancy_sum / self.pool_samples,
                           4)),
            "pool_low_watermark": self.pool_low_watermark,
            "itl_estimate_ms": (None if itl is None
                                else round(itl * 1e3, 3)),
            "itl_p95_ms": (None if p95 is None
                           else round(p95 * 1e3, 3)),
            "replica": self.replica,
            "tp": self.tp,
            "kv_pool_bytes_per_device": self.kv_pool_bytes_per_device,
            "collectives_per_decode_step":
                self.collectives_per_decode_step,
        }


_ENGINES = []   # weakrefs; dead engines drop out of the global snapshot


def _register(m):
    _ENGINES.append(weakref.ref(m))


_SUMMED = ("requests_submitted", "requests_completed", "requests_rejected",
           "requests_timed_out", "requests_cancelled", "requests_shed",
           "tokens_generated", "prefills", "decode_steps", "preemptions",
           "chunked_prefills", "chunk_steps", "prefix_hit_tokens",
           "prompt_tokens", "cow_copies", "spec_steps", "draft_steps",
           "spec_proposed_tokens", "spec_accepted_tokens",
           "spec_emitted_tokens")


def global_counters():
    """The snapshot summed across every live engine: counts added, peaks
    and the low watermark their extremes, the rates recomputed from the
    sums."""
    total = {"engines": 0, **{k: 0 for k in _SUMMED},
             "peak_queue_depth": 0, "peak_active": 0,
             "prefix_hit_rate": None, "pool_low_watermark": None,
             "tp_max": 1, "spec_acceptance_rate": None}
    live = []
    for ref in _ENGINES:
        m = ref()
        if m is None:
            continue
        live.append(ref)
        s = m.snapshot()
        total["engines"] += 1
        for k in _SUMMED:
            total[k] += s[k]
        total["peak_queue_depth"] = max(total["peak_queue_depth"],
                                        s["peak_queue_depth"])
        total["peak_active"] = max(total["peak_active"], s["peak_active"])
        total["tp_max"] = max(total["tp_max"], s["tp"])
        if s["pool_low_watermark"] is not None:
            lw = total["pool_low_watermark"]
            total["pool_low_watermark"] = (
                s["pool_low_watermark"] if lw is None
                else min(lw, s["pool_low_watermark"]))
    _ENGINES[:] = live
    if total["prompt_tokens"]:
        total["prefix_hit_rate"] = round(
            total["prefix_hit_tokens"] / total["prompt_tokens"], 4)
    if total["spec_proposed_tokens"]:
        total["spec_acceptance_rate"] = round(
            total["spec_accepted_tokens"]
            / total["spec_proposed_tokens"], 4)
    return total


def ledger(handles):
    """Aggregate a finished workload's handles into one latency ledger
    (p50/p95 TTFT and inter-token latency in ms, total tokens/sec)."""
    done = [h for h in handles if h.metrics.finish_time is not None]
    ttfts = [h.metrics.ttft for h in done if h.metrics.ttft is not None]
    itls = [d for h in done for d in h.metrics.inter_token_latencies]
    total_tokens = sum(h.metrics.n_tokens for h in done)
    t0 = min((h.metrics.submit_time for h in done), default=0.0)
    t1 = max((h.metrics.finish_time for h in done), default=0.0)
    wall = max(t1 - t0, 1e-9)
    ms = 1e3
    return {
        "requests": len(done),
        "total_new_tokens": total_tokens,
        "tokens_per_sec": round(total_tokens / wall, 2),
        "ttft_ms_p50": round((_percentile(ttfts, 50) or 0) * ms, 3),
        "ttft_ms_p95": round((_percentile(ttfts, 95) or 0) * ms, 3),
        "itl_ms_p50": round((_percentile(itls, 50) or 0) * ms, 3),
        "itl_ms_p95": round((_percentile(itls, 95) or 0) * ms, 3),
    }
