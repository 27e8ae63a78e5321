"""Serving-side fault tolerance: the engine supervisor. Counterpart of
``paddle_tpu/serving/resilience.py``.

A wedged or crashed decode step would take down the Engine and every
request in flight with it. :class:`EngineSupervisor` wraps an
:class:`~paddle_tpu_torch.serving.engine.Engine`:

* **detect** -- a step that raises, one that exceeds ``step_timeout_s``
  (the step runs on a worker thread, joined with that timeout), or live
  KV that fails the finiteness probe (``kv_probe_interval``);
* **rebuild** -- the condemned engine is replaced by a fresh one (fresh
  KV pools and device state; the weights are the model's, shared as
  views);
* **replay, token-identically** -- every surviving request is re-admitted
  through ``Engine.adopt``: it re-prefills ``prompt + emitted`` and its
  key chain is fast-forwarded past the emitted tokens, so it emits what
  the uninterrupted run would have, sampled output included. KV
  corruption is healed the same way: the replay recomputes the KV from
  the request's own tokens.

Graceful degradation under overload rides the same loop: priority + EDF
admission (the engine's ``PriorityScheduler``), brownout shedding while
the rolling decode ITL p95 exceeds ``itl_slo_ms`` (the lowest queued
class is shed each step with a finite ``retry_after_s``, and new
unprotected work is rejected), and ``drain()``/``reopen()``.

Chaos: pass a :class:`~paddle_tpu_torch.resilience.ChaosMonkey` whose plan
uses the serving faults (``decode-stall`` / ``decode-raise`` /
``kv-corrupt`` / ``abandon``); ``tools/torch_chaos_serve.py`` drives each
to a JSON verdict.

On the GPU: the worker thread launches on the process's CUDA context and
stream like the main thread. A step abandoned at its timeout keeps
running on the condemned engine (its pools, its device state) until it
returns, beside the rebuilt engine's own; the condemned engine drops
whatever it would emit. The probe reads the live blocks of both pools
with one reduction each and one device-to-host read.

Under tensor parallelism (``EngineSupervisor(model, tp=N, ...)``) every
rank of the tp group runs the supervisor, making the same calls in the
same order (the engine's SPMD contract), and a fault verdict is the
group's, never one rank's. A gloo control group of the supervisor's own
carries the verdicts, apart from the engine's tp group, where a step
thread abandoned at its timeout may still sit in a collective:

* before each supervised step one all-reduce agrees on the injected
  chaos fault, the KV probe's finding on every rank's shard, rank 0's
  rolling ITL p95 (the brownout decision: wall clocks decide on rank 0
  only) and the fault's trace id;
* after each attempt one all-reduce agrees on its outcome: a raise on any
  rank, or a step past ``step_timeout_s`` on any rank (a rank that raised
  inside its step leaves its peers in a collective: they see a wedge at
  ``step_timeout_s``, so set one under tp), condemns the group; a failure
  gathers every rank's error into one message;
* a condemned attempt is undone on every rank: a rank whose step
  finished before a peer's timeout has emitted that step's tokens (and
  may have finished a request), so every live handle goes back to what
  it held before the attempt (its tokens, finish state and stamps); the
  replay emits those tokens again, the same ones, and ``on_token``
  streams each token once;
* every rank then rebuilds at the same supervised step, on a FRESH tp
  group (``Mesh.fresh_group``, made by every rank in the same order), and
  re-admits the same survivors in the same order through ``adopt``, whose
  guard checks that the ranks' handles agree.

``sup.engine.tp`` stays N, and ``rebuilds``, ``replayed`` and the ledger
records (their wall-clock stamps aside) are equal on every rank. A
``ChaosMonkey(ranks=...)`` fault confined to one rank (a raise, a stall
inside its decode step, a corrupted block of its KV shard) still gives one
rebuild of the whole group at one step, and so does a rank that wedges
after its step's last collective (``stall_inside(late=True)``). A tp-1
engine that every rank of a ``ReplicaFleet`` with mixed tp degrees runs
as a replica in lockstep is supervised the same way, over the fleet's
control group, its engine's guards over a fresh group of those ranks.
``verdicts``/``verdict_s`` count the verdicts' collectives and their
wall. Retry-after hints stay each rank's own.
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from ..distributed import collective as _C
from ..distributed import mesh as _mesh
from ..observability import tracing as _tracing
from ..resilience.chaos import (ChaosError, StallInjected, corrupt_kv,
                                stall_inside)
from ..resilience.ledger import FlightLedger
from ..resilience.supervisor import StepTimeout
from .engine import Engine
from .scheduler import EngineOverloaded
from .speculative import SPEC_COUNTER_KEYS

__all__ = ["EngineSupervisor", "ServingAborted", "EngineDraining",
           "global_counters"]


class ServingAborted(RuntimeError):
    """The rebuild ladder ran out of rungs: more than ``max_rebuilds``
    consecutive rebuilds failed to produce a healthy decode step. Carries
    the supervisor's stats snapshot."""

    def __init__(self, message, stats=None):
        super().__init__(message)
        self.stats = stats


class EngineDraining(RuntimeError):
    """submit() was called while the supervisor is draining: admission is
    closed; in-flight work finishes, nothing new starts."""


class EngineSupervisor:
    """Wrap a serving Engine with detect / rebuild / replay plus overload
    degradation (see the module docstring).

    The supervisor OWNS engine construction (it must be able to rebuild
    one): pass the model plus any ``Engine`` kwargs. Its surface mirrors
    the engine's -- ``submit() -> RequestHandle``, ``step()``,
    ``drain()``, ``stats()`` -- and its handles pump the supervised step,
    so ``handle.result()`` rides through faults.

    ``step_timeout_s`` runs each engine step on a worker thread and treats
    a step that has not returned by then as wedged. ``itl_slo_ms`` arms
    brownout shedding of the classes above ``shed_protect_priority``.
    ``kv_probe_interval=N`` probes the live KV every N supervised steps
    (one host read a probe: pick a sparse cadence in production).
    ``replica_id`` and ``migrate_hook`` are the ``ReplicaFleet``'s: the
    hook is offered the survivors of a fault before the local replay, and
    whatever it adopts elsewhere is not replayed here.

    ``tp=N`` (an ``Engine`` argument) supervises a tensor-parallel engine:
    every rank of its tp group runs the supervisor in lockstep (see the
    module docstring). ``_control_group`` is the fleet's plumbing: the
    group whose verdicts bind every member (under tp by default a fresh
    gloo group over the tp ranks); given to a tp-1 supervisor it makes
    that engine a replica every member runs in lockstep.
    """

    def __init__(self, model, *, step_timeout_s=None, max_rebuilds=3,
                 retry_backoff_s=0.02, itl_slo_ms=None,
                 shed_protect_priority=0, kv_probe_interval=0,
                 chaos=None, ledger=None, replica_id=None,
                 migrate_hook=None, _control_group=None, **engine_kwargs):
        self._model = model
        self.tp = int(engine_kwargs.get("tp", 1))
        # the mesh each tp incarnation gets a fresh tp group of
        self._mesh = None
        if self.tp > 1:
            self._mesh = (engine_kwargs.pop("mesh", None)
                          or _mesh.configured_mesh()
                          or _mesh.build_mesh(tp=self.tp))
            if _control_group is None:
                _control_group = self._mesh.fresh_group("tp",
                                                        backend="gloo")
        self._ctl = (_control_group if _control_group is not None
                     and _control_group.nranks > 1 else None)
        self._engine_kwargs = dict(engine_kwargs)
        self.replica_id = replica_id
        self.migrate_hook = migrate_hook
        # a one-shot fault the fleet injects into this replica, and how
        # long an injected stall blocks (the fleet sets its chaos's)
        self._pending_fault = None
        self._stall_s = 0.01
        self.step_timeout_s = step_timeout_s
        self.max_rebuilds = int(max_rebuilds)
        self.retry_backoff_s = float(retry_backoff_s)
        self.itl_slo_s = None if itl_slo_ms is None else itl_slo_ms / 1e3
        self.shed_protect_priority = int(shed_protect_priority)
        self.kv_probe_interval = int(kv_probe_interval)
        self.chaos = chaos
        self.ledger = (ledger if ledger is not None
                       else FlightLedger(scope="serving"))
        self.engine = self._build()
        # program usage and speculative counters across incarnations
        self.buckets_seen_total = set()
        self.chunk_used_total = False
        self.rebuilds = 0
        self.verify_used_total = False
        self.draft_buckets_total = set()
        self.draft_decode_used_total = False
        self.spec_totals = {k: 0 for k in SPEC_COUNTER_KEYS}
        self.replayed = 0              # handles re-admitted with tokens
        self.wedges = 0
        self.step_errors = 0
        self.kv_corruptions = 0
        self.shed = 0
        self.abandoned = 0
        self.drains = 0
        self.brownout_steps = 0
        # the probe's cost: probes that read the device, and their wall
        self.kv_probes = 0
        self.kv_probe_s = 0.0
        # the lockstep verdicts' cost: collectives made, and their wall
        self.verdicts = 0
        self.verdict_s = 0.0
        self.draining = False
        self._brownout = False
        self._steps_since_probe = 0
        self._probe_where = []
        self._aborted = False
        self._last_fault_trace_id = None
        _register(self)

    def _build(self):
        """A fresh engine; in lockstep, on a fresh group (every member
        makes it in the same order): the tp group of a tp engine, the
        guard group of a replicated tp-1 engine."""
        kw = dict(self._engine_kwargs)
        if self.tp > 1:
            kw.update(mesh=self._mesh,
                      _group=self._mesh.fresh_group("tp"))
        elif self._ctl is not None:
            kw.update(_spmd_group=_C.new_group(
                self._ctl.ranks, backend="gloo", fresh=True))
        return Engine(self._model, replica_id=self.replica_id, **kw)

    def inject(self, fault, trace_id=None):
        """Arm a one-shot serving fault (``decode-stall`` /
        ``decode-raise``) for the next supervised step: the ReplicaFleet's
        chaos channel into one replica."""
        self._pending_fault = fault
        if trace_id is not None:
            self._last_fault_trace_id = trace_id

    def rebuild(self, why="requested"):
        """Condemn the current engine and build a fresh one, migrating or
        replaying the survivors as after a detected fault (the fleet's
        ``replica-kill``)."""
        self._rebuild_and_replay(why=why)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, *, priority=0, **kw):
        """Engine.submit under supervision: the handle's ``result()``
        pumps the supervised step. Raises :class:`EngineDraining` while
        draining, and ``EngineOverloaded`` (finite ``retry_after_s``) for
        unprotected priorities during brownout."""
        if self.draining:
            raise EngineDraining(
                "supervisor is draining: admission closed; retry "
                "against the replacement deployment")
        if self._brownout and priority > self.shed_protect_priority:
            hint = self.engine._retry_after_hint()
            self.engine.metrics.requests_rejected += 1
            self.ledger.record("brownout-reject", priority=priority,
                               retry_after_s=hint)
            raise EngineOverloaded(
                f"brownout: ITL p95 over SLO -- priority {priority} "
                f"rejected; retry after ~{hint}s", retry_after_s=hint,
                replica=self.replica_id)
        h = self.engine.submit(prompt, max_new_tokens, priority=priority,
                               **kw)
        h._engine = self      # result() pumps the SUPERVISED step
        return h

    def cancel(self, handle):
        """Client abandoned the stream (Engine.cancel)."""
        return self.engine.cancel(handle)

    # -- the supervised step -----------------------------------------------

    def step(self):
        """One supervised iteration: the planned chaos fault fires, the
        KV is probed, brownout sheds, then the engine steps behind the
        detect -> rebuild -> replay ladder. In lockstep the fault, the
        probe's finding, the brownout clock and each attempt's outcome are
        the group's (see the module docstring)."""
        if self._aborted:
            raise ServingAborted("supervisor already aborted",
                                 stats=self.stats())
        fault, confined, fired, stall = None, False, None, self._stall_s
        if self.chaos is not None:
            step_no = self.chaos.calls
            fault = self.chaos.take(
                rank=0 if self._ctl is None else self._ctl.rank)
            confined = step_no in self.chaos.ranks
            stall = self.chaos.stall_s
        if fault is not None:
            self._last_fault_trace_id = fired = self.chaos.last_trace_id
        elif self._pending_fault is not None:
            # fleet-injected one-shot fault (inject() set the trace id)
            fault, self._pending_fault = self._pending_fault, None
            fired = self._last_fault_trace_id
        if fault == "kv-corrupt":
            try:
                corrupt_kv(self.engine, seed=self.chaos.seed)
            except ValueError:
                pass   # nothing live: the planned fault is a no-op
            fault = None          # latent: the probe must find it
        elif fault == "abandon":
            self._abandon_one()
            fault = None
        elif fault == "decode-stall" and confined:
            # this rank alone wedges, inside its decode step: its peers
            # wait in the step's first collective; every rank's step
            # timeout then condemns the group
            if not self.step_timeout_s:
                raise ValueError("a decode-stall confined to one rank is "
                                 "found by step_timeout_s: set one")
            stall_inside(self.engine, stall)
            fault = None
        bad = self._probe_kv()
        p95 = self.engine.metrics.itl_p95()
        if self._ctl is not None:
            fault, bad, p95 = self._agree_pre(fault, bad, p95, fired)
        if bad:
            self._kv_verdict()
            p95 = None        # the rebuilt engine has no decode history
        self._brownout_tick(p95)
        failures = 0
        while True:
            out, err = None, None
            before = self._mark()
            try:
                if fault == "decode-stall":
                    fault = None
                    time.sleep(stall)
                    raise StallInjected(
                        f"chaos: decode step wedged for {stall}s "
                        f"(replica={self.replica_id})")
                if fault == "decode-raise":
                    fault = None
                    raise ChaosError(
                        f"chaos: decode step failed "
                        f"(replica={self.replica_id})")
                if fault == "peer":
                    # another rank's injected fault: this rank follows
                    fault = None
                    raise _PeerFault()
                out = self._engine_step()
            except Exception as e:
                err = e
            kind = None if err is None else (
                "wedge" if isinstance(err, TimeoutError) else "step-error")
            msg = (None if err is None or isinstance(err, _PeerFault)
                   else f"{type(err).__name__}: {err}")
            if self._ctl is not None:
                kind, msg = self._agree_outcome(kind, msg)
            if kind is None:
                return out
            if kind == "wedge":
                self.wedges += 1
            else:
                self.step_errors += 1
            self.ledger.record("anomaly", kind=kind, error=msg,
                               trace_id=self._last_fault_trace_id)
            failures += 1
            if failures > self.max_rebuilds:
                self._abort(err if err is not None
                            and not isinstance(err, _PeerFault)
                            else RuntimeError(msg))
            self._rebuild_and_replay(why=kind, before=before)
            time.sleep(self.retry_backoff_s * failures)

    # -- the group's verdicts (lockstep only) -------------------------------

    def _verdict(self, **kw):
        """One lockstep collective over the control group, counted and
        timed (``verdicts``, ``verdict_s``)."""
        t0 = time.perf_counter()
        out = _C.agree(self._ctl, **kw)
        self.verdicts += 1
        self.verdict_s += time.perf_counter() - t0
        return out

    def _agree_pre(self, fault, bad, p95, fired):
        """The pre-step verdict: the injected fault (a raise or a stall on
        any rank), the probe's finding on any rank's shard, rank 0's
        rolling ITL p95, and the trace id of a fault fired this step (the
        highest pid's when several ranks fired one). Returns the group's
        (fault, bad, p95); a fault of another rank is ``"peer"`` here."""
        code = {"decode-raise": 2, "decode-stall": 1}.get(fault, 0)
        (p95,), (code, bad, tid) = self._verdict(
            rank0=[-1.0 if p95 is None else p95],
            maximum=[code, float(bool(bad)), _tracing.trace_id_float(fired)])
        if tid != float("-inf"):
            self._last_fault_trace_id = _tracing.trace_id_of(tid)
        group_fault = {2: "decode-raise", 1: "decode-stall"}.get(int(code))
        if group_fault is not None and fault != group_fault:
            fault = "peer"
        return fault, bool(bad), (None if p95 < 0 else p95)

    def _agree_outcome(self, kind, msg):
        """The post-attempt verdict: any rank's raise makes it a step
        error, else any rank's timeout a wedge; on a failure every rank's
        error is gathered into one message, the same on every rank."""
        code = {None: 0, "wedge": 1, "step-error": 2}[kind]
        _, (code,) = self._verdict(maximum=[code])
        kind = {0: None, 1: "wedge", 2: "step-error"}[int(code)]
        if kind is None:
            return None, None
        msgs = [None] * self._ctl.nranks
        torch.distributed.all_gather_object(msgs, msg,
                                            group=self._ctl.pg)
        return kind, "; ".join(f"rank {r}: {m}" for r, m in enumerate(msgs)
                               if m)

    def _engine_step(self):
        eng = self.engine
        if not self.step_timeout_s:
            return eng.step()
        box = {}

        def run():
            try:
                box["out"] = eng.step()
            except BaseException as e:   # crossing threads: rethrown below
                box["err"] = e

        t = threading.Thread(target=run, daemon=True,
                             name="supervised-decode")
        t.start()
        t.join(self.step_timeout_s)
        if t.is_alive():
            # a timeout condemns the group whatever the verdict: the
            # abandoned step emits nothing from here on
            eng._condemned = True
            raise StepTimeout(
                f"decode step did not return within "
                f"{self.step_timeout_s}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    # -- detect ------------------------------------------------------------

    def _probe_kv(self):
        """Finiteness probe over the live KV (this rank's shard under tp):
        poisoned state (chaos fault ``kv-corrupt``) is caught BEFORE the
        next decode step reads it, so the replay from tokens stays
        token-identical. A paged engine's probe walks its LIVE blocks only
        (those its occupied slots' tables hold), a slot engine's its active
        slots: one gather and finiteness reduction per pool and one host
        read. True when they hold a non-finite value. A corrupted SHARED
        prefix block is
        healed for every sharer at once: the rebuild re-admits all of them
        through a fresh radix index."""
        if not self.kv_probe_interval:
            return False
        self._steps_since_probe += 1
        if self._steps_since_probe < self.kv_probe_interval:
            return False
        self._steps_since_probe = 0
        cache = self.engine.cache
        if hasattr(cache, "live_blocks"):          # paged pool
            where = cache.live_blocks()
        else:
            where = [int(s) for s in np.nonzero(cache.active)[0]]
        self._probe_where = [int(s) for s in where]
        if not where:
            return False
        t0 = time.perf_counter()
        with torch.no_grad():
            idx = torch.tensor(where, device=cache.kc.device)
            ok = (torch.isfinite(cache.kc.index_select(1, idx)).all()
                  & torch.isfinite(cache.vc.index_select(1, idx)).all())
            ok = bool(ok)                            # the one host read
        self.kv_probes += 1
        self.kv_probe_s += time.perf_counter() - t0
        return not ok

    def _kv_verdict(self):
        """The probe found poisoned KV (on any rank's shard in lockstep):
        condemn and replay."""
        self.kv_corruptions += 1
        self.ledger.record("anomaly", kind="kv-corrupt",
                           slots=self._probe_where,
                           trace_id=self._last_fault_trace_id)
        self._rebuild_and_replay(why="kv-corrupt")

    # -- rebuild + replay --------------------------------------------------

    def _mark(self):
        """The engine's live handles (the active ones by request id, then
        the queued ones in queue order), each with what a step may change
        on it: its token count and its token stamps."""
        eng = self.engine
        actives = sorted((h for h in eng._by_slot
                          if h is not None and not h.finished),
                         key=lambda h: h.request_id)
        queued = [h for h in list(eng.scheduler._queue) if not h.finished]
        return actives, queued, [
            (h, len(h.tokens), len(h.metrics.token_times),
             h.metrics.first_token_time) for h in actives + queued]

    @staticmethod
    def _roll_back(states):
        """Undo a condemned attempt on this rank's handles: each goes back
        to its ``_mark`` (a step that finished here before a peer's
        timeout emitted tokens, and may have finished a request, that the
        group's verdict takes back; the replay emits them again)."""
        for h, n, n_times, first in states:
            del h.tokens[n:]
            h.finished, h.finish_reason = False, None
            m = h.metrics
            del m.token_times[n_times:]
            m.first_token_time, m.finish_time = first, None

    def _rebuild_and_replay(self, why, before=None):
        """Condemn the broken engine, build a fresh one and re-admit every
        survivor through ``adopt``: active handles re-prefill ``prompt +
        emitted`` with their key chain fast-forwarded, queued ones
        re-enqueue untouched. ``before`` is the ``_mark`` taken before a
        condemned attempt: its handles are rolled back to it and replayed
        in its order. With a fleet ``migrate_hook`` the survivors
        are first offered to healthy peers; whatever the hook absorbs
        keeps decoding there and this replica rebuilds without it."""
        old = self.engine
        old._condemned = True
        if before is None:
            before = self._mark()
        else:
            self._roll_back(before[2])
        actives, queued, _ = before
        survivors = actives + queued
        self.buckets_seen_total |= old.buckets_seen
        self.chunk_used_total |= bool(old.chunk_used)
        self.verify_used_total |= bool(old.verify_used)
        self.draft_buckets_total |= set(old.draft_buckets_seen)
        self.draft_decode_used_total |= bool(old.draft_decode_used)
        for k in self.spec_totals:
            self.spec_totals[k] += getattr(old.metrics, k, 0)
        migrated = []
        if self.migrate_hook is not None and survivors:
            migrated = list(self.migrate_hook(self, survivors, why) or ())
            gone = set(map(id, migrated))
            survivors = [h for h in survivors if id(h) not in gone]
        self.engine = self._build()
        self.engine._next_id = old._next_id
        self.rebuilds += 1
        self.ledger.record("rebuild", why=why, replica=self.replica_id,
                           n_active=len(actives),
                           n_queued=len(queued),
                           n_migrated=len(migrated),
                           trace_id=self._last_fault_trace_id,
                           request_traces=[h.trace_id
                                           for h in actives + queued])
        for h in survivors:
            if h.tokens:
                self.replayed += 1
            self.engine.adopt(h)
            h._engine = self
        self.ledger.record("replay", n=len(survivors),
                           migrated=len(migrated))

    def _abandon_one(self):
        """Chaos fault ``abandon``: the longest-running client disconnects
        mid-stream (deterministic pick: the lowest request id)."""
        eng = self.engine
        cand = [h for h in eng._by_slot if h is not None]
        if not cand:
            cand = list(eng.scheduler._queue)
        if not cand:
            return
        target = min(cand, key=lambda h: h.request_id)
        if self.cancel(target):
            self.abandoned += 1
            self.ledger.record("abandon", request_id=target.request_id,
                               tokens=len(target.tokens))

    # -- graceful degradation ----------------------------------------------

    def _brownout_tick(self, p95):
        """While the rolling decode ITL p95 (rank 0's in lockstep) exceeds
        the SLO, shed the lowest queued class (finite retry_after_s) each
        step and reject new unprotected work; protected classes keep
        decoding."""
        if self.itl_slo_s is None:
            return
        if p95 is None:
            return
        if p95 > self.itl_slo_s:
            if not self._brownout:
                self._brownout = True
                self.ledger.record("brownout-enter",
                                   itl_p95_ms=round(p95 * 1e3, 3))
            self.brownout_steps += 1
            shed = self.engine.shed_queued(self.shed_protect_priority)
            if shed:
                self.shed += len(shed)
                self.ledger.record(
                    "shed", n=len(shed),
                    retry_after_s=shed[0].retry_after_s,
                    priorities=sorted({h.priority for h in shed}))
        elif self._brownout:
            self._brownout = False
            self.ledger.record("brownout-exit",
                               itl_p95_ms=round(p95 * 1e3, 3))

    def drain(self, max_steps=100000):
        """Stop admission, pump supervised steps (fault recovery stays
        active) until every submitted request has finished, and report.
        :meth:`reopen` accepts work again."""
        self.draining = True
        self.ledger.record("drain-begin",
                           queued=self.engine.scheduler.queue_depth,
                           active=self.engine.cache.n_active)
        steps = 0
        while (self.engine.scheduler.queue_depth
               or self.engine.cache.n_active) and steps < max_steps:
            self.step()     # self.engine may be rebuilt mid-drain
            steps += 1
        drained = (self.engine.scheduler.queue_depth == 0
                   and self.engine.cache.n_active == 0)
        self.drains += 1
        report = {"drained": drained, "steps": steps,
                  "completed": self.engine.metrics.requests_completed,
                  "rebuilds_during": self.rebuilds}
        self.ledger.record("drain", **report)
        return report

    def reopen(self):
        """Re-open admission after a completed drain."""
        self.draining = False

    # -- observability -----------------------------------------------------

    def counters(self):
        """This supervisor's serving-resilience counters (summed across
        live supervisors by ``global_counters()``)."""
        return {"rebuilds": self.rebuilds, "replayed": self.replayed,
                "wedges": self.wedges, "step_errors": self.step_errors,
                "kv_corruptions": self.kv_corruptions, "shed": self.shed,
                "abandoned": self.abandoned, "drains": self.drains,
                "brownout_steps": self.brownout_steps}

    def spec_counters(self):
        """Speculative counters summed over every engine incarnation this
        supervisor has owned (condemned + live): they survive a
        rebuild."""
        return {k: self.spec_totals[k] + getattr(self.engine.metrics, k, 0)
                for k in self.spec_totals}

    def stats(self):
        out = {**self.counters(), "replica": self.replica_id,
               "brownout": self._brownout, "draining": self.draining,
               "buckets_seen_total": sorted(
                   self.buckets_seen_total | self.engine.buckets_seen),
               "kv_probe": {"probes": self.kv_probes,
                            "seconds": self.kv_probe_s},
               "verdicts": {"calls": self.verdicts,
                            "seconds": self.verdict_s},
               "ledger": self.ledger.counts(),
               "engine": self.engine.stats()}
        if self.engine.spec is not None:
            out["spec_counters_total"] = self.spec_counters()
        return out

    def _abort(self, exc):
        self._aborted = True
        stats = self.stats()
        self.ledger.record("abort",
                           exception=f"{type(exc).__name__}: {exc}")
        raise ServingAborted(
            f"serving aborted after {self.rebuilds} rebuilds "
            f"({self.max_rebuilds} consecutive failures): "
            f"{type(exc).__name__}: {exc}", stats=stats) from exc


class _PeerFault(Exception):
    """This rank's step was not attempted: another rank of the lockstep
    group drew an injected fault for it."""


_SUPERVISORS = []    # weakrefs; dead supervisors drop out of the snapshot


def _register(sup):
    _SUPERVISORS.append(weakref.ref(sup))


def global_counters():
    """Counters summed across every live EngineSupervisor."""
    total = {"supervisors": 0, "rebuilds": 0, "replayed": 0, "wedges": 0,
             "step_errors": 0, "kv_corruptions": 0, "shed": 0,
             "abandoned": 0, "drains": 0, "brownout_steps": 0}
    live = []
    for ref in _SUPERVISORS:
        s = ref()
        if s is None:
            continue
        live.append(ref)
        total["supervisors"] += 1
        for k, v in s.counters().items():
            total[k] = total.get(k, 0) + v
    _SUPERVISORS[:] = live
    return total
