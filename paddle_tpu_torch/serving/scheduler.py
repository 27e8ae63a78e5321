"""Request admission for the serving engine.

A copy of ``paddle_tpu/serving/scheduler.py`` (pure Python; the port
keeps its own so it imports nothing of the JAX package).

Two schedulers share the guard machinery: :class:`FIFOScheduler`
(strict arrival order) and :class:`PriorityScheduler` (the Engine
default — priority classes with EDF deadline ordering within a class,
falling back to exact FIFO behavior for all-default traffic).

FIFO with two guards:

- **token-budget watermark** — the sum of ``prompt_len + max_new_tokens``
  over in-flight requests stays under ``token_budget``; the queue head
  waits (strict FIFO, no head-of-line skipping) until enough slots drain.
  Keeps worst-case KV residency bounded independent of n_slots.
- **queue-depth backpressure** — ``enqueue`` raises EngineOverloaded once
  ``max_queue`` requests are waiting; callers shed load instead of
  growing an unbounded host-side queue.

Admission order is a pure function of arrival order (deque + watermark,
no timestamps), which together with per-request PRNG chains makes every
request's output independent of co-batched traffic.
"""
from __future__ import annotations

import collections


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the waiting queue is at max_queue depth.

    ``retry_after_s`` (when the engine has decode-latency history) is
    the estimated seconds until a slot frees — clients should back off
    at least that long before resubmitting. ``replica`` names the fleet
    replica that refused the request (None standalone; None also on a
    fleet-wide rejection, where EVERY replica was browned out).
    """

    def __init__(self, message, retry_after_s=None, replica=None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.replica = replica


class FIFOScheduler:
    def __init__(self, token_budget, max_queue):
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.token_budget = int(token_budget)
        self.max_queue = int(max_queue)
        self._queue = collections.deque()
        self._inflight_tokens = 0

    @staticmethod
    def _load(handle):
        return handle.n_prompt + handle.max_new_tokens

    @staticmethod
    def _immediate(handle):
        """Token lines the request needs the moment it admits: prompt +
        already-emitted replay tokens + the first decode write line.
        The paged engine gates admission on this against the pool's
        free-block headroom (``free_tokens``) instead of reserving the
        worst case — decode growth allocates lazily, preemption covers
        the tail risk."""
        return (handle.n_prompt + len(getattr(handle, "tokens", ())) + 1)

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def inflight_tokens(self):
        return self._inflight_tokens

    def enqueue(self, handle, retry_after_s=None):
        if len(self._queue) >= self.max_queue:
            hint = ("" if retry_after_s is None
                    else f" ~{retry_after_s}s (current inter-token "
                         f"latency x shortest active request)")
            raise EngineOverloaded(
                f"serving queue full ({self.max_queue} waiting); retry "
                f"after{hint or ' the engine drains'}",
                retry_after_s=retry_after_s,
                replica=getattr(handle, "replica_id", None))
        self._queue.append(handle)

    def has_deadlines(self):
        """True when a queued handle carries a deadline."""
        return any(getattr(h, "deadline", None) is not None
                   for h in self._queue)

    def drop_expired(self, now):
        """Remove and return queued handles whose deadline passed while
        they waited — they never held a slot or token-budget share, so
        nothing is released."""
        expired = [h for h in self._queue
                   if getattr(h, "deadline", None) is not None
                   and now > h.deadline]
        if expired:
            dead = set(map(id, expired))
            self._queue = collections.deque(
                h for h in self._queue if id(h) not in dead)
        return expired

    def pop_admissible(self, free_slots, free_tokens=None):
        """Pop the FIFO prefix that fits in ``free_slots``, the token
        watermark, and (when given) ``free_tokens`` — the paged pool's
        free-block headroom in token lines, so admission accounts FREE
        BLOCKS, not worst-case slot reservations. Popped handles are
        counted in-flight immediately; call release() when their request
        finishes."""
        out = []
        while self._queue and free_slots > 0:
            head = self._queue[0]
            need = self._load(head)
            if self._inflight_tokens + need > self.token_budget and \
                    self._inflight_tokens > 0:
                break   # strict FIFO: head waits, nothing overtakes it
            if free_tokens is not None:
                imm = self._immediate(head)
                if imm > free_tokens:
                    break   # head waits for blocks; nothing overtakes
                free_tokens -= imm
            out.append(self._queue.popleft())
            self._inflight_tokens += need
            free_slots -= 1
        return out

    def requeue(self, handle):
        """Put a preempted (or pool-bounced) handle back at the front of
        arrival order, bypassing max_queue backpressure — it was already
        admitted once and holds no budget share while queued."""
        self._queue.appendleft(handle)

    def remove(self, handle):
        """Drop one queued handle (client abandon). Queued handles hold
        no budget share, so nothing is released. True if it was
        queued."""
        try:
            self._queue.remove(handle)
            return True
        except ValueError:
            return False

    def release(self, handle):
        self._inflight_tokens -= self._load(handle)


class PriorityScheduler(FIFOScheduler):
    """Priority classes + deadline-aware (EDF) admission.

    Queued requests admit in ``(priority, deadline, arrival)`` order: a
    lower priority number always admits first; within a class, requests
    carrying wall-clock deadlines run earliest-deadline-first (they are
    exactly the ones overload would expire while they wait), and
    deadline-less requests keep strict FIFO arrival order behind them.
    The token watermark applies to the sorted head exactly as in the
    FIFO base: the most urgent waiting request blocks admission rather
    than being overtaken, so a class can never starve its own head.
    With all-default priorities and no deadlines this degenerates to
    strict FIFO — the Engine default costs nothing.
    """

    @staticmethod
    def _key(h):
        d = getattr(h, "deadline", None)
        return (getattr(h, "priority", 0),
                d if d is not None else float("inf"),
                getattr(h, "request_id", 0))

    def pop_admissible(self, free_slots, free_tokens=None):
        out = []
        while self._queue and free_slots > 0:
            head = min(self._queue, key=self._key)
            need = self._load(head)
            if self._inflight_tokens + need > self.token_budget and \
                    self._inflight_tokens > 0:
                break   # the most urgent request waits; nothing overtakes
            if free_tokens is not None:
                imm = self._immediate(head)
                if imm > free_tokens:
                    break   # urgent head waits for blocks; no overtaking
                free_tokens -= imm
            self._queue.remove(head)
            out.append(head)
            self._inflight_tokens += need
            free_slots -= 1
        return out
