"""Deterministic, seeded fault injection. Counterpart of
``paddle_tpu/resilience/chaos.py``: the same fault names, plans and
draws, so a plan seeded the same fires the same faults at the same steps
in both packages.

Every recovery path of the serving supervisor and the replica fleet must
be exercised by test, not by luck: ``ChaosMonkey`` fires faults at
deterministically chosen steps, so a run with ``seed=7`` reproduces the
exact failure sequence of any previous run with ``seed=7``.

Faults
------

Training (``wrap(step_fn)``): ``nan`` (the step returns a non-finite
loss), ``stall`` (blocks ``stall_s``, then raises :class:`StallInjected`),
``error`` (raises :class:`ChaosError`), ``kill`` (SIGKILL to the process),
``corrupt`` (the newest committed checkpoint of ``ChaosMonkey(manager=)``
gets one file truncated, then the step runs; restore must detect the bad
checksum and fall back). :func:`corrupt_checkpoint` draws its victim file
and byte as the JAX package's does, so one seed damages the same file and
byte of two copies of one tree.

Serving (consumed by ``serving.resilience.EngineSupervisor`` through
:meth:`ChaosMonkey.take`; the supervisor performs the injection, because
each fault manipulates live engine state): ``decode-stall`` (the decode
step wedges past its deadline, then fails), ``decode-raise`` (the decode
step raises), ``kv-corrupt`` (live KV poisoned in place by
:func:`corrupt_kv`; the supervisor's probe must catch it before the next
decode step reads it), ``abandon`` (a client abandons a request
mid-stream).

Fleet (consumed by ``serving.fleet.ReplicaFleet``, one fault per fleet
step into a deterministically chosen replica): ``replica-kill``,
``route-flap`` and the decode and KV faults above.

Schedules are explicit (``at={step: fault}``) or drawn from a seeded RNG
(``p`` per-step probability over ``faults``); both are pure functions of
the constructor arguments, so under tensor parallelism every rank, built
with the same arguments, draws the same plan and ``take()`` consumes it
identically. ``ranks={step: r}`` confines the fault planned at ``step``
to rank ``r`` of the supervisor's tp group (``take(rank=)``): a
``decode-raise``, a ``decode-stall`` (the rank's engine step wedges inside
its decode, ``stall_inside``) or a ``kv-corrupt`` of that rank's KV shard,
while the other ranks consume the same step with no fault; the group must
still rebuild as one. Each fired fault gets a trace id and, while tracing
is on, a ``chaos.<fault>`` instant carrying it.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from ..observability import tracing as _tracing

__all__ = ["FAULTS", "SERVING_FAULTS", "FLEET_FAULTS", "ChaosError",
           "StallInjected", "ChaosMonkey", "corrupt_kv", "stall_inside",
           "corrupt_checkpoint", "corrupt_latest"]

FAULTS = ("nan", "stall", "error", "kill", "corrupt")
SERVING_FAULTS = ("decode-stall", "decode-raise", "kv-corrupt", "abandon")
FLEET_FAULTS = ("replica-kill", "route-flap", "decode-stall",
                "decode-raise", "kv-corrupt")

class ChaosError(RuntimeError):
    """Injected transient step failure (RPC-error analog)."""


class StallInjected(TimeoutError):
    """Injected wedged step: blocked past the deadline, then failed."""


class ChaosMonkey:
    """Faults at deterministic steps.

    ``at`` maps 0-based step invocation index -> fault name for an
    explicit plan; alternatively ``p`` > 0 draws a schedule from
    ``numpy.random.default_rng(seed)`` over ``faults`` for ``horizon``
    steps. ``take()`` (serving) and ``wrap(step_fn)`` (training) count
    invocations, so the Nth call meets the fault planned for step N.

    ``ranks`` maps a planned step to the one rank (of the supervisor's tp
    group) its serving fault fires on; ``take(rank=)`` returns it there
    only. ``decode-raise``, ``decode-stall`` and ``kv-corrupt`` may be
    confined; ``abandon`` (a client's cancel, which every rank must make)
    may not.
    """

    def __init__(self, seed: int = 0, *, at=None, p: float = 0.0,
                 faults=("nan", "stall", "error"), horizon: int = 1024,
                 stall_s: float = 0.25, manager=None, ranks=None):
        self.seed = int(seed)
        self.stall_s = float(stall_s)
        self.manager = manager
        self.calls = 0
        self.fired = []                 # [(step, fault)]
        self.trace_ids = {}             # step -> trace id
        self.last_trace_id = None
        known = FAULTS + SERVING_FAULTS + FLEET_FAULTS
        for f in tuple(dict(at or {}).values()) + tuple(faults):
            if f not in known:
                raise ValueError(f"unknown fault {f!r} (one of {known})")
        self.plan = {int(k): v for k, v in (at or {}).items()}
        self.ranks = {int(k): int(r) for k, r in (ranks or {}).items()}
        for step in self.ranks:
            if self.plan.get(step) not in ("decode-raise", "decode-stall",
                                           "kv-corrupt"):
                raise ValueError(
                    f"ranks= confines decode-raise, decode-stall or "
                    f"kv-corrupt to one rank; step {step} plans "
                    f"{self.plan.get(step)!r}")
        if p > 0.0:
            rng = np.random.default_rng(self.seed)
            for step in range(int(horizon)):
                if step in self.plan:
                    continue
                if rng.random() < p:
                    self.plan[step] = str(rng.choice(list(faults)))

    def schedule(self, n_steps: int):
        """The fault plan restricted to the first ``n_steps`` steps."""
        return {s: f for s, f in sorted(self.plan.items()) if s < n_steps}

    def take(self, rank=None):
        """Consume one supervised step's planned fault (or None) without
        executing it; counts an invocation exactly like :meth:`wrap`'s
        chaotic step. A fault ``ranks`` confines to another rank than
        ``rank`` is None here."""
        step = self.calls
        self.calls += 1
        fault = self.plan.get(step)
        only = self.ranks.get(step)
        if fault is not None and (only is None or only == rank):
            self.fired.append((step, fault))
            self._mark_fired(step, fault)
            return fault
        return None

    def _mark_fired(self, step, fault):
        tid = _tracing.new_trace_id()
        self.trace_ids[step] = tid
        self.last_trace_id = tid
        if _tracing._ENABLED:
            _tracing.instant(f"chaos.{fault}", cat="chaos", trace_id=tid,
                             step=step, seed=self.seed)

    def wrap(self, step_fn):
        def chaotic_step(*args, **kwargs):
            step = self.calls
            self.calls += 1
            fault = self.plan.get(step)
            if fault is not None:
                self.fired.append((step, fault))
                self._mark_fired(step, fault)
                return self._fire(fault, step_fn, args, kwargs)
            return step_fn(*args, **kwargs)

        chaotic_step.chaos = self
        return chaotic_step

    def _fire(self, fault, step_fn, args, kwargs):
        if fault == "nan":
            return float("nan")
        if fault == "stall":
            time.sleep(self.stall_s)
            raise StallInjected(
                f"chaos: step wedged for {self.stall_s}s (seed={self.seed})")
        if fault == "error":
            raise ChaosError(f"chaos: transient step failure "
                             f"(seed={self.seed})")
        if fault == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
            raise RuntimeError("unreachable: SIGKILL did not fire")
        if fault == "corrupt":
            if self.manager is None:
                raise ValueError(
                    "chaos fault 'corrupt' needs ChaosMonkey(manager=...)")
            corrupt_latest(self.manager, seed=self.seed)
            return step_fn(*args, **kwargs)
        raise ValueError(f"unknown fault {fault!r}")


def corrupt_checkpoint(path, seed: int = 0, mode: str = "truncate"):
    """Damage a committed checkpoint dir in place.

    ``truncate`` halves a deterministically chosen data file; ``flip``
    xors one byte; ``uncommit`` removes the COMMIT marker (simulating a
    kill after rename of a pre-manifest writer). Returns the damaged
    file path (or the marker path for ``uncommit``).
    """
    path = os.path.abspath(path)
    if mode == "uncommit":
        marker = os.path.join(path, "COMMIT")
        os.remove(marker)
        return marker
    files = []
    for root, _dirs, names in os.walk(path):
        for name in names:
            if name == "COMMIT":
                continue
            full = os.path.join(root, name)
            if os.path.getsize(full) > 0:
                files.append(full)
    if not files:
        raise FileNotFoundError(f"no data files to corrupt under {path}")
    files.sort()
    rng = np.random.default_rng(seed)
    victim = files[int(rng.integers(len(files)))]
    size = os.path.getsize(victim)
    if mode == "truncate":
        with open(victim, "rb+") as fh:
            fh.truncate(max(size // 2, 1))
    elif mode == "flip":
        off = int(rng.integers(size))
        with open(victim, "rb+") as fh:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return victim


def corrupt_latest(manager, seed: int = 0, mode: str = "truncate"):
    """Corrupt the newest committed checkpoint of a CheckpointManager."""
    manager.wait()
    step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"no checkpoints under {manager.directory}")
    return corrupt_checkpoint(
        os.path.join(manager.directory, f"ckpt-{step}"), seed=seed,
        mode=mode)


def corrupt_kv(engine, seed: int = 0, value: float = float("nan")):
    """Serving-side corruption (chaos fault ``kv-corrupt``): poison
    deterministically chosen live KV state in place. The
    EngineSupervisor's finiteness probe must catch it before the next
    decode step reads it; rebuild-and-replay then heals the state by
    recomputing KV from each request's own prompt + emitted tokens.

    Slot layout: one active slot's attendable lines are poisoned (returns
    the slot). Paged layout: one live BLOCK is poisoned, a SHARED prefix
    block (refcount > 1) when one exists (every sharer reads it, so all of
    them must be healed by the replay); returns the block id. The draws
    are JAX's, so the same engine state picks the same block."""
    rng = np.random.default_rng(seed)
    cache = engine.cache
    with torch.no_grad():
        if hasattr(cache, "live_blocks"):          # paged pool
            shared = cache.shared_live_blocks()
            cand = shared if shared else cache.live_blocks()
            if not cand:
                raise ValueError("no live blocks to corrupt")
            block = int(cand[int(rng.integers(len(cand)))])
            cache.kc[:, block] = value
            return block
        active = np.nonzero(cache.active)[0]
        if active.size == 0:
            raise ValueError("no active slots to corrupt")
        slot = int(active[int(rng.integers(active.size))])
        lines = max(int(cache.cur_pos[slot]), 1)
        cache.kc[:, slot, :lines] = value
        return slot


def stall_inside(engine, seconds, late=False):
    """Serving fault ``decode-stall`` confined to one rank: the engine's
    next decode step sleeps ``seconds`` inside ``_decode_once`` (past the
    step's entry, before its collectives), so the rank's step wedges where
    a slow or stuck rank would, and its peers wait in the step's first
    collective. ``late=True`` sleeps after the step's sampled tokens are
    read instead, past its last collective: the peers finish the step and
    emit its tokens while this rank wedges (a slow device-to-host read or
    a host stall). One shot: the wrapper removes itself when it runs."""
    name = "_read_tokens" if late else "_decode_once"
    inner = getattr(engine, name)

    def stalled(arg):
        delattr(engine, name)          # back to the class's method
        if late:
            out = inner(arg)
            time.sleep(seconds)
            return out
        time.sleep(seconds)
        return inner(arg)

    setattr(engine, name, stalled)
