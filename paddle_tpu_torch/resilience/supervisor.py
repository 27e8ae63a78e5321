"""Fault-tolerant training supervisor. Counterpart of
``paddle_tpu/resilience/supervisor.py``.

Grows ``utils.watchdog.TrainingWatchdog`` (which only *detects*) into a
component that detects, records, and *recovers*: the supervisor wraps
any train step (an eager closure, a Fleet ``TrainStep`` or a
``CommOptTrainStep``) behind an escalation ladder:

1. **skip**    a non-finite loss restores the pre-step in-memory guard
               snapshot, so neither params nor optimizer moments are
               poisoned, and moves on to the next batch;
2. **retry**   a step that raises (or exceeds ``step_timeout_s``: the
               wedged-step case) is retried with backoff from the guard
               snapshot;
3. **rollback** when retries or NaN patience are exhausted, state rolls
               back to the newest durable checkpoint;
4. **abort**   when rollbacks are exhausted too, a post-mortem (config,
               anomaly counts, flight-ledger tail) is written and
               :class:`SupervisorAborted` raised.

It drives ``distributed.checkpoint.CheckpointManager`` on a step cadence
plus an emergency save when the first anomaly of a streak appears, and
resumes through ``distributed.elastic.maybe_resume`` on restart. The
durable snapshot covers params, optimizer moments, every RNG generator
(``framework.random_seed.get_rng_state``), AMP loss-scaler state and the
dataloader position (sampler epoch + batch index); with the atomic
COMMIT checkpoint format a run SIGKILLed at any instant resumes with
losses bitwise-equal to the uninterrupted one.

Where the port differs, because its tensors are updated in place:

* A snapshot is a **copy** on each tensor's device (JAX's captures
  arrays by reference, which is safe only because JAX arrays are
  immutable). A restore copies out of the snapshot, so one guard serves
  every retry and rollback of an incident.
* A step abandoned by ``step_timeout_s`` is condemned
  (``framework.attempt``): ``TrainStep``, ``CommOptTrainStep`` and
  ``Optimizer.step`` drop its in-place writes when it wakes up, and the
  gradients an ended one left in the eager ``param.grad`` are cleared
  before the next attempt. A user closure that writes other state in
  place is not covered; nor is a step wedged inside its own backward
  while the retry runs (ROADMAP.md, "Divergences kept on purpose"). A
  step still inside its in-place writes ``step_timeout_s`` after it was
  abandoned leaves nothing to restore under it: the supervisor aborts.
  ``Supervisor.zombies`` lists the abandoned threads.
* The ``train.step`` and ``train.checkpoint`` spans are port queue item
  8; ``TrainState(program=)`` (a static program) is item 9.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..framework import attempt
from ..observability import tracing as _tracing
from ..utils.watchdog import TrainingWatchdog
from .ledger import FlightLedger


# what a span site enters while tracing is off
_NO_SPAN = contextlib.nullcontext()
__all__ = ["StepTimeout", "SupervisorAborted", "TrainState",
           "ResumableLoader", "Supervisor"]


class SupervisorAborted(RuntimeError):
    """The escalation ladder ran out of rungs. Carries the post-mortem."""

    def __init__(self, message, postmortem=None, path=None):
        super().__init__(message)
        self.postmortem = postmortem
        self.path = path


class StepTimeout(TimeoutError):
    """A supervised step exceeded ``step_timeout_s`` (wedged step)."""


class _WedgedInCommit(StepTimeout):
    """An abandoned attempt still holds its in-place writes open."""


# ---------------------------------------------------------------------------
# snapshot plumbing
# ---------------------------------------------------------------------------

def _capture_leaves(obj, copy=True):
    """Copy a nested dict/list structure to checkpointable leaves:
    tensors are cloned on their devices (kept as they are when not
    ``copy``), numpy arrays are copied, python scalars become 0-d arrays,
    and ``None`` values are dropped (no holes in the tree)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if copy else t
    if isinstance(obj, dict):
        return {k: _capture_leaves(v, copy) for k, v in obj.items()
                if v is not None}
    if isinstance(obj, (list, tuple)):
        return [_capture_leaves(v, copy) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (bool, int, float, np.generic)):
        return np.asarray(obj)
    return obj


def _scalars(obj):
    """Undo the 0-d array encoding for config-ish dicts (loss-scaler,
    LR-scheduler, loader state), so restored values are python scalars
    again."""
    if isinstance(obj, dict):
        return {k: _scalars(v) for k, v in obj.items()}
    if getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def _rank():
    from ..distributed.collective import get_rank
    return get_rank()


class TrainState:
    """Snapshot/restore façade over the moving parts of a training loop.

    Pass the pieces the loop owns; any subset works:

    * ``model`` / ``optimizer``: an eager ``nn.Module`` and ``Optimizer``
      (params, moments via their ``state_dict`` contracts)
    * ``scaler``: an ``amp.GradScaler`` (dynamic loss scale state)
    * ``loader``: a :class:`ResumableLoader` (sampler epoch + batch
      index)
    * ``train_step``: a Fleet ``TrainStep`` or a ``CommOptTrainStep``:
      its ``state_dict`` (params, moments, residuals, buffers, the
      in-step scaler state) is the canonical copy, so don't also pass
      model/optimizer
    * ``extra_capture``/``extra_restore``: callables for anything else

    Every RNG generator's state is always captured, so dropout continues
    bit-exactly across a resume. ``program=`` (a static program) is not in
    the port: it raises ``NotImplementedError`` (ROADMAP.md, port queue
    item 9).
    """

    def __init__(self, model=None, optimizer=None, scaler=None,
                 loader=None, train_step=None, program=None,
                 extra_capture: Optional[Callable[[], Any]] = None,
                 extra_restore: Optional[Callable[[Any], None]] = None):
        if program is not None:
            raise NotImplementedError(
                "TrainState(program=): the port has no static program "
                "(ROADMAP.md, port queue item 9: long tail)")
        self.model = model
        self.optimizer = optimizer
        self.scaler = scaler
        self.loader = loader
        self.train_step = train_step
        self._extra_capture = extra_capture
        self._extra_restore = extra_restore

    def capture(self, copy=True):
        """A nested dict of copies (checkpointable) describing the full
        training state right now. ``copy=False`` references the live
        tensors instead, for a consumer that copies them before the next
        step (``CheckpointManager.save`` does)."""
        from ..framework import random_seed

        def leaves(obj):
            return _capture_leaves(obj, copy)

        snap = {"rng": leaves(random_seed.get_rng_state())}
        if self.model is not None:
            snap["model"] = {k: leaves(v) for k, v
                             in self.model.state_dict().items()}
        if self.optimizer is not None:
            # materialize lazily-created moment state first: a capture
            # taken before step 1 (the resume template) must have the
            # same tree structure as one taken after training began
            opt = self.optimizer
            try:
                for k, p in opt._all_params().items():
                    if p.requires_grad and opt._state.get(k) is None:
                        opt._state[k] = opt.init_param_state(p.detach())
            except ValueError:
                pass    # an optimizer without a parameter list
            snap["optimizer"] = leaves(opt.state_dict())
        if self.scaler is not None:
            snap["scaler"] = leaves(self.scaler.state_dict())
        if self.loader is not None:
            snap["loader"] = leaves(self.loader.state_dict())
        if self.train_step is not None:
            snap["train_step"] = leaves(self.train_step.state_dict())
        if self._extra_capture is not None:
            snap["extra"] = leaves(self._extra_capture())
        return snap

    def restore(self, snap):
        """Copy ``snap`` (a ``capture()``, or a checkpoint of one) into
        the live state; ``snap`` stays untouched. A
        ``distributed.checkpoint.RankStates`` (a checkpoint of another
        number of ranks) gives the train step every rank's state, and the
        rest this rank's (rank 0's when this rank had none)."""
        from ..distributed.checkpoint import RankStates
        from ..framework import random_seed

        step_state = None
        if isinstance(snap, RankStates):
            if self.train_step is not None:
                step_state = RankStates(s["train_step"] for s in snap)
            r = _rank()
            snap = snap[r if r < len(snap) else 0]
        elif self.train_step is not None and "train_step" in snap:
            step_state = snap["train_step"]
        if "rng" in snap:
            random_seed.set_rng_state(snap["rng"])
        if self.model is not None and "model" in snap:
            live = self.model.state_dict(keep_vars=True)
            missing = sorted(set(live) - set(snap["model"]))
            if missing:
                raise KeyError(f"snapshot lacks model entries {missing}")
            with torch.no_grad():
                for k, t in live.items():
                    t.copy_(torch.as_tensor(snap["model"][k]))
        if self.optimizer is not None and "optimizer" in snap:
            self.optimizer.set_state_dict({
                k: (_scalars(v) if k in ("_lr", "_lr_scheduler") else v)
                for k, v in snap["optimizer"].items()})
        if self.scaler is not None and "scaler" in snap:
            self.scaler.load_state_dict(_scalars(snap["scaler"]))
        if self.loader is not None and "loader" in snap:
            self.loader.set_state_dict(_scalars(snap["loader"]))
        if step_state is not None:
            self.train_step.load_state_dict(step_state)
        if self._extra_restore is not None and "extra" in snap:
            self._extra_restore(snap["extra"])


class ResumableLoader:
    """Dataloader position tracker: iterate this instead of the raw
    DataLoader and the (epoch, batch index) cursor becomes part of the
    supervisor snapshot, so a resumed run continues mid-epoch on the
    exact next batch.

    Restore fast-forwards by drawing and discarding ``batch_index``
    batches of the restored epoch: exact for any sampler whose order is
    a pure function of the epoch (SequenceSampler, epoch-seeded
    DistributedBatchSampler); a globally-seeded RandomSampler is only
    reproducible if the script reseeds before iterating.
    """

    def __init__(self, loader, epochs: int = 1):
        self.loader = loader
        self.epochs = int(epochs)
        self.epoch = 0
        self.batch_index = 0

    def _set_epoch(self, epoch):
        sampler = getattr(self.loader, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)

    def __iter__(self):
        while self.epoch < self.epochs:
            self._set_epoch(self.epoch)
            skip = self.batch_index
            for i, batch in enumerate(self.loader):
                if i < skip:
                    continue            # fast-forward to the cursor
                self.batch_index = i + 1
                yield batch
            self.epoch += 1
            self.batch_index = 0

    def state_dict(self):
        return {"epoch": self.epoch, "batch_index": self.batch_index}

    def set_state_dict(self, state):
        self.epoch = int(state["epoch"])
        self.batch_index = int(state["batch_index"])

    load_state_dict = set_state_dict


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class Supervisor:
    """Wrap ``step_fn(*batch) -> loss`` with the escalation ladder.

    ``state`` (a :class:`TrainState`) enables recovery: without it the
    supervisor only detects and records. ``manager`` (a
    ``CheckpointManager``) enables the durable rungs: cadence saves
    every ``save_interval`` completed steps, emergency save on the first
    anomaly of a streak, rollback, and :meth:`resume`.

    ``step()`` returns the loss for a healthy step and ``None`` for a
    skipped one. ``step_timeout_s`` runs the step on a worker thread and
    treats a non-return within the deadline as a wedged step: the thread
    is abandoned (its in-place writes are then dropped, see the module
    docstring) and the state restored from the guard snapshot before the
    retry.
    """

    def __init__(self, step_fn: Callable, state: Optional[TrainState] = None,
                 *, manager=None, save_interval: int = 0,
                 step_timeout_s: Optional[float] = None,
                 nan_patience: int = 3, max_retries: int = 2,
                 retry_backoff_s: float = 0.05, max_rollbacks: int = 1,
                 guard_interval: int = 1, emergency_save: bool = True,
                 ledger: Optional[FlightLedger] = None,
                 postmortem_path: Optional[str] = None):
        self.step_fn = step_fn
        self.state = state
        self.manager = manager
        self.save_interval = int(save_interval)
        self.step_timeout_s = step_timeout_s
        self.nan_patience = int(nan_patience)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_rollbacks = int(max_rollbacks)
        self.guard_interval = max(1, int(guard_interval))
        self.emergency_save = bool(emergency_save)
        self.postmortem_path = postmortem_path
        if ledger is None and manager is not None:
            ledger = FlightLedger(
                os.path.join(manager.directory, "flight.jsonl"))
        self.ledger = ledger if ledger is not None else FlightLedger()
        self.watchdog = TrainingWatchdog(
            step_timeout_s=step_timeout_s or 600.0,
            nan_patience=max(self.nan_patience, 1),
            on_stall=lambda gap: self.ledger.record(
                "anomaly", kind="inter-step-stall", gap_s=round(gap, 3)),
            on_nan=lambda streak: None)
        self.steps_completed = 0
        self.skipped = 0
        self.rollbacks = 0
        self.retries = 0
        self.anomalies = {}
        self.zombies: list = []         # abandoned worker threads
        self._unreaped: list = []       # ... whose gradients may linger
        self._guard = None
        self._guard_step = 0
        self._nan_streak = 0
        self._last_saved_step = None
        self._aborted = False

    # -- durability --------------------------------------------------------

    def resume(self) -> int:
        """Restore the newest durable snapshot (if any) through
        ``elastic.maybe_resume`` and return the next step index to run
        (0 for a fresh start). Call once at script start; a relaunched
        process continues exactly where the checkpoint left off."""
        if self.manager is None:
            return 0
        from ..distributed.elastic import attempt_number, maybe_resume

        template = self.state.capture() if self.state is not None else None
        next_step, snap = maybe_resume(self.manager, template)
        if snap is None and template is not None \
                and self.manager.latest_step() is not None:
            # checkpoints exist but none matched this TrainState's tree
            # (component drift, e.g. restored without the scaler):
            # template-free load still recovers the stored arrays
            next_step, snap = maybe_resume(self.manager, None)
        if snap is not None and self.state is not None:
            self.state.restore(snap)
            self.steps_completed = next_step
            self._last_saved_step = next_step - 1
        self.ledger.record("resume", next_step=next_step,
                           fresh=snap is None,
                           attempt=attempt_number())
        return self.steps_completed

    def save_now(self, reason="manual", async_save=True):
        """Durable save of the current state, labeled with the index of
        the last completed step."""
        if self.manager is None or self.state is None:
            return None
        label = self.steps_completed - 1
        if label < 0:
            return None
        # the manager copies to the host before it returns
        with (_tracing.span("train.checkpoint", cat="train", step=label,
                            reason=reason)
              if _tracing._ENABLED else _NO_SPAN):
            path = self.manager.save(label, self.state.capture(copy=False),
                                     async_save=async_save)
        self._last_saved_step = label
        self.ledger.record("save", step=label, reason=reason)
        return path

    def _emergency_save(self):
        """First anomaly of a streak: persist the last known-good state
        (the guard snapshot) before anything else goes wrong."""
        if not (self.emergency_save and self.manager is not None
                and self._guard is not None):
            return
        label = self._guard_step - 1
        if label < 0 or label == self._last_saved_step \
                or label in self.manager.all_steps():
            return      # that state is already durable
        self.manager.save(label, self._guard, async_save=True)
        self._last_saved_step = label
        self.ledger.record("save", step=label, reason="emergency")

    def _can_rollback(self):
        # the per-incident budget is rollbacks_here in step(); lifetime
        # rollbacks are unbounded: every independent incident gets the
        # full ladder
        return (self.manager is not None and self.state is not None
                and self.manager.latest_step() is not None)

    def _restore_latest_snap(self):
        try:
            return self.manager.restore_latest(self.state.capture())
        except FileNotFoundError:
            # snapshot-tree drift can make every step "unloadable" under
            # a template; the stored arrays are fine: load template-free
            return self.manager.restore_latest(None)

    def _rollback(self, why):
        step, snap = self._restore_latest_snap()
        self.state.restore(snap)
        self.steps_completed = step + 1
        self.rollbacks += 1
        self._nan_streak = 0
        self._guard = self.state.capture()
        self._guard_step = self.steps_completed
        self.ledger.record("rollback", to_step=step, why=why)
        return step

    # -- the ladder --------------------------------------------------------

    def _anomaly(self, kind, **fields):
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1
        self.ledger.record("anomaly", kind=kind,
                           step=self.steps_completed, **fields)

    def _call_step(self, args, kwargs):
        if not self.step_timeout_s:
            return self.step_fn(*args, **kwargs)
        box = {}

        def run():
            try:
                box["out"] = self.step_fn(*args, **kwargs)
            except BaseException as e:  # crossing threads: rethrown below
                box["err"] = e

        t = threading.Thread(target=run, daemon=True,
                             name="supervised-step")
        t.start()
        t.join(self.step_timeout_s)
        if t.is_alive():
            self.zombies.append(t)
            self._unreaped.append(t)
            # its later writes are dropped; one under way is waited for
            if not attempt.abandon(t, timeout=self.step_timeout_s):
                raise _WedgedInCommit(
                    f"step wedged inside its in-place writes for over "
                    f"{2 * self.step_timeout_s}s: the state cannot be "
                    f"restored under it")
            raise StepTimeout(
                f"step did not return within {self.step_timeout_s}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def _reap_zombies(self):
        """An abandoned attempt that has since ended ran its backward
        into ``param.grad`` of the eager model before its update was
        refused: clear those gradients before the next attempt runs."""
        ended = [t for t in self._unreaped if not t.is_alive()]
        if not ended or self.state is None:
            return
        self._unreaped = [t for t in self._unreaped if t.is_alive()]
        params = []
        if self.state.model is not None:
            params += list(self.state.model.parameters())
        if self.state.optimizer is not None:
            try:
                params += list(self.state.optimizer._all_params().values())
            except ValueError:
                pass    # an optimizer without a parameter list
        for p in params:
            p.grad = None

    @staticmethod
    def _loss_value(loss):
        if loss is None:
            return None
        try:
            if isinstance(loss, torch.Tensor):
                return float(loss.detach().float().cpu())
            return float(np.asarray(loss))
        except (TypeError, ValueError, RuntimeError):
            return None

    def step(self, *args, **kwargs):
        """Run one supervised step; see the class docstring for the
        ladder. Raises SupervisorAborted when recovery is exhausted."""
        if self._aborted:
            raise SupervisorAborted("supervisor already aborted")
        if self.state is not None and (
                self._guard is None
                or self.steps_completed - self._guard_step
                >= self.guard_interval):
            self._guard = self.state.capture()
            self._guard_step = self.steps_completed
        attempt_no = 0
        rollbacks_here = 0
        while True:
            self._reap_zombies()
            t0 = time.perf_counter()
            try:
                with (_tracing.span("train.step", cat="train",
                                    step=self.steps_completed,
                                    attempt=attempt_no)
                      if _tracing._ENABLED else _NO_SPAN):
                    loss = self._call_step(args, kwargs)
            except _WedgedInCommit as e:
                self._anomaly("stall", error=f"{type(e).__name__}: {e}")
                self._emergency_save()      # the guard is a copy: intact
                self._abort(e)
            except Exception as e:
                kind = ("stall" if isinstance(e, TimeoutError)
                        else "step-error")
                self._anomaly(kind, error=f"{type(e).__name__}: {e}")
                self._emergency_save()
                if self.state is not None and self._guard is not None:
                    self.state.restore(self._guard)
                if attempt_no < self.max_retries:
                    attempt_no += 1
                    self.retries += 1
                    self.ledger.record("retry", step=self.steps_completed,
                                       attempt=attempt_no)
                    time.sleep(self.retry_backoff_s * attempt_no)
                    continue
                if rollbacks_here < self.max_rollbacks \
                        and self._can_rollback():
                    try:
                        self._rollback(why=kind)
                    except Exception as re:
                        self._anomaly("rollback-failed",
                                      error=f"{type(re).__name__}: {re}")
                        self._abort(re)
                    rollbacks_here += 1
                    attempt_no = 0
                    continue
                self._abort(e)
            dur = time.perf_counter() - t0
            lval = self._loss_value(loss)
            try:
                healthy = self.watchdog.step(lval)
            except FloatingPointError:
                healthy = False      # patience handled by our own streak
            if self.step_timeout_s and dur > self.step_timeout_s:
                self._anomaly("slow-step", duration_s=round(dur, 3))
            if healthy:
                self._nan_streak = 0
                self.steps_completed += 1
                self.ledger.record("step", step=self.steps_completed - 1,
                                   loss=lval, duration_s=round(dur, 6))
                if self.save_interval and \
                        self.steps_completed % self.save_interval == 0:
                    self.save_now(reason="cadence")
                return loss
            # non-finite loss: skip without touching optimizer state
            self._nan_streak += 1
            self._anomaly("nonfinite", loss=str(lval), streak=self._nan_streak)
            self._emergency_save()
            if self.state is not None and self._guard is not None:
                self.state.restore(self._guard)
            if self._nan_streak >= self.nan_patience:
                if rollbacks_here < self.max_rollbacks \
                        and self._can_rollback():
                    try:
                        self._rollback(why="nonfinite-streak")
                    except Exception as re:
                        self._anomaly("rollback-failed",
                                      error=f"{type(re).__name__}: {re}")
                        self._abort(re)
                    rollbacks_here += 1
                    continue
                self._abort(FloatingPointError(
                    f"loss non-finite for {self._nan_streak} supervised "
                    f"steps"))
            self.steps_completed += 1   # the batch is consumed
            self.skipped += 1
            return None

    # -- post-mortem -------------------------------------------------------

    def stats(self):
        return {"steps_completed": self.steps_completed,
                "skipped": self.skipped, "retries": self.retries,
                "rollbacks": self.rollbacks,
                "anomalies": dict(self.anomalies),
                "watchdog": dict(self.watchdog.stats),
                "last_saved_step": self._last_saved_step}

    def close(self):
        """Join any in-flight async checkpoint write. Call at the end of
        a run (or rely on abort/rollback, which join implicitly)."""
        if self.manager is not None:
            self.manager.wait()

    def _abort(self, exc):
        self._aborted = True
        inflight_err = None
        if self.manager is not None:
            try:
                self.manager.wait()     # post-mortem must not race a save
            except Exception as e:
                inflight_err = f"{type(e).__name__}: {e}"
        pm = {"aborted_at_step": self.steps_completed,
              "inflight_save_error": inflight_err,
              "exception": f"{type(exc).__name__}: {exc}",
              "stats": self.stats(),
              "checkpoint_dir": getattr(self.manager, "directory", None),
              "latest_durable_step": (self.manager.latest_step()
                                      if self.manager is not None else None),
              "ledger_tail": self.ledger.tail(50)}
        path = self.postmortem_path
        if path is None and self.manager is not None:
            path = os.path.join(self.manager.directory, "postmortem.json")
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(pm, fh, indent=2, default=str)
            os.replace(tmp, path)
        self.ledger.record("abort", step=self.steps_completed,
                           exception=pm["exception"], postmortem=path)
        raise SupervisorAborted(
            f"training aborted at step {self.steps_completed}: "
            f"{pm['exception']}"
            + (f" (post-mortem: {path})" if path else ""),
            postmortem=pm, path=path) from exc
