"""Replica fleet: many engines as ONE service. Counterpart of
``paddle_tpu/serving/fleet.py``.

An ``EngineSupervisor`` heals one engine, but every request in flight
waits while that engine rebuilds. :class:`ReplicaFleet` owns N
data-parallel Engine replicas, each behind its own supervisor, with one
admission front end above them:

* **prefix-aware routing** -- a request goes to the replica whose radix
  index already holds its longest full-block prefix (probed read-only, so
  routing never perturbs any replica's LRU), ties broken by load: queued
  + active requests, the rolling decode ITL p95 and pool pressure;
* **fault isolation + migration** -- a replica whose engine wedges,
  raises or fails the KV probe hands its surviving requests to healthy
  peers through ``Engine.adopt()`` (token-identical: the replay runs from
  tokens) while it rebuilds and re-registers;
* **jittered-backoff retry** -- a replica that refuses (brownout, a full
  queue) is skipped for its ``retry_after_s``, jittered to half-to-full;
* **fleet-level degradation** -- the lowest priority class is shed
  FLEET-WIDE only when EVERY routable replica is browned out.

The replicas share the model's weights: each engine's arch object holds
views of the model's parameters (``text.generation.layer_weights``), so
N replicas on one card cost N KV pools and one copy of the weights.

Health state machine per replica (``ReplicaFleet.stats``):

    healthy -> degraded      brownout (rolling ITL p95 over SLO)
    healthy -> draining      fault detected / replica killed: requests
                             migrate out, the engine rebuilds
    draining -> healthy      rebuild done + ``cooldown_steps`` quiet
                             fleet steps: the replica re-registers
    * -> condemned           the supervisor's rebuild ladder ran out
                             (ServingAborted): out of routing for good

Chaos: a :class:`~paddle_tpu_torch.resilience.ChaosMonkey` with the fleet
faults (``replica-kill`` / ``decode-stall`` / ``decode-raise`` /
``kv-corrupt`` / ``route-flap``) fires one fault per fleet step into a
deterministically chosen replica; ``tools/torch_chaos_serve.py --fleet
N`` emits the JSON verdict.

Not in this slice: replicas with ``tp > 1`` (``tp_degrees`` other than
all 1) raise ``NotImplementedError`` (ROADMAP.md, port queue: serving
robustness); the profiler line and the metrics registry's gauges are
port queue item 8.
"""
from __future__ import annotations

import itertools
import time
import weakref

import numpy as np

from ..resilience.chaos import corrupt_kv
from ..resilience.ledger import FlightLedger
from .engine import Engine, _not_in_slice
from .resilience import EngineDraining, EngineSupervisor, ServingAborted
from .scheduler import EngineOverloaded

__all__ = ["ReplicaFleet", "REPLICA_STATES", "global_counters"]

#: The replica health states.
REPLICA_STATES = ("healthy", "degraded", "draining", "condemned")

_FLEET_SEQ = itertools.count()


class _Replica:
    """One supervised engine + its fleet-side routing state."""

    __slots__ = ("id", "index", "sup", "state", "cooldown")

    def __init__(self, rid, index, sup):
        self.id = rid
        self.index = index
        self.sup = sup
        self.state = "healthy"
        self.cooldown = 0

    @property
    def engine(self):
        return self.sup.engine


class ReplicaFleet:
    """N supervised Engine replicas behind one admission front end (see
    the module docstring).

    The fleet OWNS replica construction: pass the model plus any
    ``Engine``/``EngineSupervisor`` kwargs (``itl_slo_ms``,
    ``kv_probe_interval``, ``step_timeout_s``, ``n_slots``, ... are
    applied to every replica). ``tp_degrees`` gives each replica its
    tensor-parallel degree; only all 1 is in this slice. The public
    surface mirrors the supervisor's: ``submit() -> RequestHandle`` (the
    handle pumps the whole fleet, so ``result()`` rides through any
    replica's fault), ``step()``, ``drain()``/``reopen()``, ``stats()``.

    ``cooldown_steps`` is how many quiet fleet steps a rebuilt replica
    stays out of routing before re-registering as healthy;
    ``max_route_attempts`` bounds how many replicas one ``submit``
    tries before giving up (default: all of them).
    """

    def __init__(self, model, n_replicas=2, *, tp_degrees=None,
                 chaos=None, ledger=None, seed=0, cooldown_steps=2,
                 max_route_attempts=None, shed_protect_priority=0,
                 name=None, **sup_kwargs):
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if tp_degrees is None:
            tp_degrees = [1] * n_replicas
        if len(tp_degrees) != n_replicas:
            raise ValueError(
                f"tp_degrees has {len(tp_degrees)} entries for "
                f"{n_replicas} replicas")
        if any(int(tp) != 1 for tp in tp_degrees):
            raise _not_in_slice(f"ReplicaFleet(tp_degrees={tp_degrees})",
                                "serving robustness")
        self.name = name or f"fleet{next(_FLEET_SEQ)}"
        self.chaos = chaos
        self.ledger = (ledger if ledger is not None
                       else FlightLedger(scope="fleet"))
        self.shed_protect_priority = int(shed_protect_priority)
        self.cooldown_steps = int(cooldown_steps)
        self._rng = np.random.default_rng(seed)
        self.replicas = {}
        for i in range(n_replicas):
            rid = f"r{i}"
            sup = EngineSupervisor(model, replica_id=rid,
                                   migrate_hook=self._on_replica_fault,
                                   **sup_kwargs)
            self.replicas[rid] = _Replica(rid, i, sup)
        self.max_route_attempts = (len(self.replicas)
                                  if max_route_attempts is None
                                  else int(max_route_attempts))
        self.draining = False
        self._backoff_until = {}     # rid -> monotonic deadline
        self._flap_submits = 0       # route-flap: randomize next K routes
        self._orphans = []           # migrations awaiting peer capacity
        # fleet counters
        self.routed = 0
        self.prefix_routed = 0
        self.migrations = 0
        self.failovers = 0
        self.replica_kills = 0
        self.route_flaps = 0
        self.fleet_sheds = 0
        self.backoffs = 0
        self.retries = 0
        self.re_registers = 0
        _register(self)

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _prefix_len(engine, ids):
        """Tokens of ``ids`` already resident in this engine's radix
        index (0 on slot engines / sharing off) -- read-only probe."""
        cache = engine.cache
        if not getattr(engine, "prefix_sharing", False):
            return 0
        return min(cache.radix.match_len(ids), len(ids))

    @staticmethod
    def _load(engine):
        """Scalar routing load: queued + active requests, the rolling
        decode ITL p95 (seconds, weighted so a browned-out replica loses
        ties decisively), and pool pressure. Lower is better."""
        p95 = engine.metrics.itl_p95() or 0.0
        used_frac = 0.0
        if hasattr(engine.cache, "pool"):
            pool = engine.cache.pool
            used_frac = pool.n_used / max(1, pool.n_blocks - 1)
        return (engine.scheduler.queue_depth + engine.cache.n_active
                + 50.0 * p95 + used_frac)

    def _routable(self, exclude=(), include_draining=False):
        dead = set(r.id for r in exclude)
        states = (("healthy", "degraded", "draining") if include_draining
                  else ("healthy", "degraded"))
        return [r for r in self.replicas.values()
                if r.state in states and r.id not in dead]

    def _route_order(self, ids, exclude=(), include_draining=False):
        """Candidate replicas, best first: longest resident prefix wins,
        load breaks ties; replicas inside their jittered backoff window
        are deferred behind the rest (but still tried last -- a fleet
        with every replica backing off must not deadlock)."""
        cands = self._routable(exclude, include_draining)
        if not cands:
            return []
        if self._flap_submits > 0:
            # chaos route-flap: affinity ignored, placement randomized --
            # the verdict proves tokens don't depend on placement
            self._flap_submits -= 1
            return [cands[int(i)]
                    for i in self._rng.permutation(len(cands))]
        now = time.monotonic()

        def key(r):
            backing_off = self._backoff_until.get(r.id, 0.0) > now
            return (backing_off, -self._prefix_len(r.engine, ids),
                    self._load(r.engine), r.index)

        return sorted(cands, key=key)

    # -- admission front end ------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, *, priority=0, **kw):
        """Route one request to the best replica (prefix affinity, then
        load), retrying peers with jittered backoff bookkeeping when a
        replica browns out or rejects on queue depth. Raises
        :class:`EngineDraining` while the fleet drains, and
        ``EngineOverloaded`` (``replica=None``, finite
        ``retry_after_s``) when every routable replica refused -- after
        shedding the lowest queued class FLEET-WIDE if the refusals
        were all brownouts."""
        if self.draining:
            raise EngineDraining(
                "fleet is draining: admission closed; retry against the "
                "replacement deployment")
        ids = Engine._as_ids(prompt)
        order = self._route_order(ids)
        if not order:
            # every peer mid-rebuild: a draining replica's fresh engine
            # is usable (in-process rebuild is synchronous) -- degrade to
            # it rather than refusing a servable fleet
            order = self._route_order(ids, include_draining=True)
        if not order:
            raise ServingAborted(
                f"{self.name}: no routable replicas (all condemned)",
                stats=self.stats())
        last = None
        for attempt, rep in enumerate(order[:self.max_route_attempts]):
            if attempt:
                self.retries += 1
            prefix = self._prefix_len(rep.engine, ids)
            try:
                h = rep.sup.submit(prompt, max_new_tokens,
                                   priority=priority, **kw)
            except EngineOverloaded as e:
                last = e
                self._note_backoff(rep, e)
                continue
            h._engine = self       # result() pumps the WHOLE fleet
            self.routed += 1
            if prefix:
                self.prefix_routed += 1
            self.ledger.record("route", replica=rep.id,
                               request_id=h.request_id,
                               trace_id=h.trace_id,
                               prefix_tokens=int(prefix),
                               attempt=attempt)
            return h
        # every routable replica refused this request
        hints = [e for e in (last,) if e is not None]
        hint = min((e.retry_after_s for e in hints
                    if e.retry_after_s is not None),
                   default=DEFAULT_FLEET_RETRY_AFTER_S)
        if self._all_browned_out() and \
                priority > self.shed_protect_priority:
            shed = self._shed_fleet_wide()
            raise EngineOverloaded(
                f"{self.name}: ALL replicas browned out -- priority "
                f"{priority} rejected fleet-wide ({shed} queued "
                f"requests shed); retry after ~{hint}s",
                retry_after_s=hint, replica=None)
        raise EngineOverloaded(
            f"{self.name}: every routable replica refused admission; "
            f"retry after ~{hint}s", retry_after_s=hint, replica=None)

    def _note_backoff(self, rep, exc):
        """Honor the replica's ``retry_after_s``: route around it until
        the (jittered, half-to-full) window elapses."""
        hint = exc.retry_after_s
        if hint is None:
            hint = rep.engine.default_retry_after_s
        until = time.monotonic() + hint * (0.5 + 0.5 * self._rng.random())
        self._backoff_until[rep.id] = until
        self.backoffs += 1
        self.ledger.record("backoff", replica=rep.id,
                           retry_after_s=hint)

    def _all_browned_out(self):
        routable = self._routable()
        return bool(routable) and all(r.sup._brownout for r in routable)

    def _shed_fleet_wide(self):
        """The all-replicas-browned-out degradation: evict the single
        globally-lowest queued priority class on EVERY replica (classes
        <= ``shed_protect_priority`` are never shed). Returns the number
        of requests shed."""
        worst = None
        for r in self._routable():
            for h in r.engine.scheduler._queue:
                p = getattr(h, "priority", 0)
                if p > self.shed_protect_priority and \
                        (worst is None or p > worst):
                    worst = p
        if worst is None:
            return 0
        n = 0
        for r in self._routable():
            n += len(r.engine.shed_queued(protect_priority=worst - 1))
        if n:
            self.fleet_sheds += n
            self.ledger.record("fleet-shed", n=n, priority=worst)
        return n

    def cancel(self, handle):
        """Client abandoned the stream: cancelled on whichever replica
        currently serves the handle."""
        for r in self.replicas.values():
            if handle in r.engine._by_slot or \
                    handle in r.engine.scheduler._queue:
                return r.sup.cancel(handle)
        if not handle.finished:    # orphaned mid-migration
            self._orphans = [h for h in self._orphans if h is not handle]
            handle.finished = True
            handle.finish_reason = "cancelled"
            return True
        return False

    # -- the fleet step -----------------------------------------------------

    def step(self):
        """One fleet iteration: fire any planned chaos fault into its
        target replica, re-place orphaned migrations, pump every
        non-condemned replica's SUPERVISED step (a replica whose ladder
        runs out is condemned and its requests fail over to peers), and
        tick the health state machine. Returns the number of requests
        that decoded this step across the fleet."""
        self._fleet_chaos()
        self._place_orphans()
        n = 0
        for rep in list(self.replicas.values()):
            if rep.state == "condemned":
                continue
            try:
                n += rep.sup.step() or 0
            except ServingAborted:
                self._condemn(rep)
        self._tick_states()
        return n

    def _condemn(self, rep):
        """The replica's rebuild ladder ran out: remove it from routing
        permanently and fail its surviving requests over to peers."""
        eng = rep.engine
        eng._condemned = True
        survivors = sorted(
            (h for h in list(eng._by_slot) + list(eng.scheduler._queue)
             if h is not None and not h.finished),
            key=lambda h: h.request_id)
        moved = self._migrate(survivors, source=rep, why="condemned")
        left = [h for h in survivors if h not in moved]
        self._orphans.extend(left)
        rep.state = "condemned"
        self.failovers += 1
        self.ledger.record("failover", replica=rep.id,
                           n_migrated=len(moved), n_orphaned=len(left))
        if not self._routable():
            raise ServingAborted(
                f"{self.name}: every replica condemned",
                stats=self.stats())

    def _tick_states(self):
        for rep in self.replicas.values():
            if rep.state == "condemned":
                continue
            if rep.state == "draining":
                rep.cooldown -= 1
                if rep.cooldown <= 0:
                    rep.state = "healthy"
                    self.re_registers += 1
                    self.ledger.record("re-register", replica=rep.id)
                continue
            rep.state = "degraded" if rep.sup._brownout else "healthy"

    # -- failover / migration ----------------------------------------------

    def _on_replica_fault(self, sup, handles, why):
        """The supervisor migrate hook: offered this replica's surviving
        requests at fault time, BEFORE its local replay. Whatever a
        healthy peer adopts keeps decoding there token-identically; the
        faulted replica drains, rebuilds empty, and re-registers after
        ``cooldown_steps``."""
        rep = next((r for r in self.replicas.values() if r.sup is sup),
                   None)
        if rep is None:
            return []
        rep.state = "draining"
        rep.cooldown = self.cooldown_steps
        return self._migrate(handles, source=rep, why=why)

    def _migrate(self, handles, source, why):
        """Adopt each handle onto the best healthy peer (prefix affinity
        over ``prompt + emitted``, then load). Handles no peer can take
        stay behind (the caller replays them locally or parks them as
        orphans). Token identity is the adopt() contract; the handle
        keeps its lifecycle trace id across the move."""
        moved = []
        for h in handles:
            full = Engine._full_ids(h)
            for rep in self._route_order(full, exclude=(source,)
                                         if source is not None else ()):
                try:
                    rep.engine.adopt(h)
                except EngineOverloaded as e:
                    self._note_backoff(rep, e)
                    continue
                h._engine = self
                moved.append(h)
                self.migrations += 1
                self.ledger.record(
                    "migrate", request_id=h.request_id,
                    trace_id=h.trace_id, why=why,
                    source=source.id if source is not None else None,
                    target=rep.id, replayed_tokens=len(h.tokens))
                break
        return moved

    def _place_orphans(self):
        if not self._orphans:
            return
        pending = [h for h in self._orphans if not h.finished]
        moved = self._migrate(pending, source=None, why="orphan")
        self._orphans = [h for h in pending if h not in moved]

    def kill_replica(self, rid, trace_id=None):
        """Kill one replica outright (the chaos ``replica-kill`` fault:
        a process death, not a detected anomaly): its engine is
        condemned on the spot, surviving requests migrate to peers, and
        the replica rebuilds + re-registers after the cooldown. Returns
        the number of requests migrated out."""
        rep = self.replicas[rid]
        self.replica_kills += 1
        before = self.migrations
        self.ledger.record("replica-kill", replica=rid,
                           trace_id=trace_id,
                           n_active=rep.engine.cache.n_active,
                           n_queued=rep.engine.scheduler.queue_depth)
        rep.sup.rebuild(why="replica-kill")   # hook migrates survivors
        rep.state = "draining"
        rep.cooldown = self.cooldown_steps
        return self.migrations - before

    # -- chaos --------------------------------------------------------------

    def _chaos_target(self):
        """Deterministic victim: the non-condemned replica with the most
        active requests (mid-decode -- the interesting case), lowest
        index on ties."""
        cands = [r for r in self.replicas.values()
                 if r.state != "condemned"]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.engine.cache.n_active,
                                         -r.index))

    def _fleet_chaos(self):
        if self.chaos is None:
            return
        fault = self.chaos.take()
        if fault is None:
            return
        tid = self.chaos.last_trace_id
        if fault == "route-flap":
            self._flap_submits += 4
            self.route_flaps += 1
            self.ledger.record("route-flap", trace_id=tid)
            return
        target = self._chaos_target()
        if target is None:
            return
        if fault == "replica-kill":
            self.kill_replica(target.id, trace_id=tid)
        elif fault == "kv-corrupt":
            try:
                # latent: the target's probe must find it
                corrupt_kv(target.engine, seed=self.chaos.seed)
            except ValueError:
                pass   # no live blocks: the planned fault is a no-op
        elif fault in ("decode-stall", "decode-raise"):
            target.sup.inject(fault, trace_id=tid)

    # -- drain / stats ------------------------------------------------------

    @property
    def n_pending(self):
        """Requests anywhere in the fleet: queued, active, or orphaned
        awaiting a migration target."""
        n = len([h for h in self._orphans if not h.finished])
        for r in self.replicas.values():
            if r.state == "condemned":
                continue
            n += r.engine.scheduler.queue_depth + r.engine.cache.n_active
        return n

    def drain(self, max_steps=100000):
        """Stop admission fleet-wide, pump supervised steps (fault
        recovery and migration stay active) until every submitted
        request finished, and report."""
        self.draining = True
        self.ledger.record("drain-begin", pending=self.n_pending)
        steps = 0
        while self.n_pending and steps < max_steps:
            self.step()
            steps += 1
        report = {"drained": self.n_pending == 0, "steps": steps,
                  "migrations": self.migrations,
                  "failovers": self.failovers}
        self.ledger.record("drain", **report)
        return report

    def reopen(self):
        self.draining = False

    def counters(self):
        states = {s: 0 for s in REPLICA_STATES}
        for r in self.replicas.values():
            states[r.state] += 1
        return {"replicas": len(self.replicas), **states,
                "routed": self.routed, "prefix_routed": self.prefix_routed,
                "migrations": self.migrations, "failovers": self.failovers,
                "replica_kills": self.replica_kills,
                "route_flaps": self.route_flaps,
                "fleet_sheds": self.fleet_sheds,
                "backoffs": self.backoffs, "retries": self.retries,
                "re_registers": self.re_registers,
                "orphans": len(self._orphans)}

    def replica_states(self):
        """{replica_id: state}: the health state machine at a glance."""
        return {rid: rep.state for rid, rep in self.replicas.items()}

    def stats(self):
        return {
            "name": self.name, **self.counters(),
            "draining": self.draining,
            "states": self.replica_states(),
            "ledger": self.ledger.counts(),
            "per_replica": {
                rid: {"state": rep.state,
                      "tp": rep.engine.tp,
                      "brownout": rep.sup._brownout,
                      "rebuilds": rep.sup.rebuilds,
                      "replayed": rep.sup.replayed,
                      "queue_depth": rep.engine.scheduler.queue_depth,
                      "active": rep.engine.cache.n_active,
                      "prefix_hit_rate":
                          rep.engine.metrics.prefix_hit_rate(),
                      "itl_p95_ms": (
                          None if rep.engine.metrics.itl_p95() is None
                          else round(rep.engine.metrics.itl_p95() * 1e3,
                                     3))}
                for rid, rep in self.replicas.items()},
        }


#: Finite fallback for a fleet-wide rejection when no replica offered a
#: hint (mirrors Engine.DEFAULT_RETRY_AFTER_S).
DEFAULT_FLEET_RETRY_AFTER_S = 1.0


_FLEETS = []    # weakrefs; dead fleets drop out of the snapshot


def _register(fleet):
    _FLEETS.append(weakref.ref(fleet))


def live_fleets():
    """Live ReplicaFleet instances (collector plumbing)."""
    out, live = [], []
    for ref in _FLEETS:
        f = ref()
        if f is None:
            continue
        live.append(ref)
        out.append(f)
    _FLEETS[:] = live
    return out


def global_counters():
    """Counters summed across every live fleet."""
    total = {"fleets": 0, "replicas": 0, "healthy": 0, "degraded": 0,
             "draining": 0, "condemned": 0, "routed": 0,
             "prefix_routed": 0, "migrations": 0, "failovers": 0,
             "replica_kills": 0, "route_flaps": 0, "fleet_sheds": 0,
             "backoffs": 0, "retries": 0, "re_registers": 0, "orphans": 0}
    for f in live_fleets():
        total["fleets"] += 1
        for k, v in f.counters().items():
            total[k] = total.get(k, 0) + v
    return total
