"""The high-level ``Model`` API. Counterpart of
``paddle_tpu/hapi/model.py``: ``prepare`` / ``fit`` / ``evaluate`` /
``predict`` / ``save`` / ``load`` with the same surface and loop.

``train_batch`` runs the fleet train step (``fleet.train_step
.make_train_step``, built at the first batch, as the JAX package's is),
so a model trained through ``Model.fit`` takes the same update as one
trained through the step directly: the flash kernels on BERT, the
optimizer in place, the LR scheduler once per update. Each batch's loss
is read to the host (the logs carry it), the one host read of a step.
``eval_batch`` and ``predict_batch`` run the network in eval mode under
``torch.no_grad()`` and put it back in training mode after, as the JAX
package does.

Datasets are batched by the port's ``io.DataLoader`` onto the device of
the network's parameters. ``save(path)`` writes ``path.pdparams`` (the
network's ``state_dict``: parameters and batch-norm statistics) and
``path.pdopt`` (the optimizer's LR state and each parameter's moments as
the train step holds them) with ``framework.io.save``, so the JAX
package's ``Model.load`` reads them, and ``load`` reads either package's
files. Moments are keyed by the parameters' structured names; the JAX
package keys its own by another scheme, so across packages the weights
and the LR state carry and the moments start afresh.
"""
from __future__ import annotations

import inspect
import os
from typing import List

import numpy as np
import torch

from ..metric import Metric
from .callbacks import CallbackList

__all__ = ["Model"]


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [] if x is None else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._amp_level = None
        self._pending_opt = None
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = _as_list(metrics)
        self._amp_level = None
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        self._train_step = None
        return self

    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    def _build_train_step(self):
        if self._train_step is not None:
            return self._train_step
        from ..distributed.fleet.train_step import make_train_step

        loss_layer = self._loss

        def loss_fn(network, *batch):
            *xs, y = batch
            return loss_layer(network(*xs), y)

        self._train_step = make_train_step(self.network, self._optimizer,
                                           loss_fn, amp_level=self._amp_level)
        if self._pending_opt is not None:
            self._load_step_opt(self._pending_opt)
        return self._train_step

    # -- batches -------------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        step = self._build_train_step()
        loss = step(*_as_list(inputs), *_as_list(labels))
        return [float(loss)]

    def eval_batch(self, inputs, labels=None):
        inputs, labels = _as_list(inputs), _as_list(labels)
        self.network.eval()
        try:
            with torch.no_grad():
                out = self.network(*inputs)
                res = []
                if self._loss is not None and labels:
                    res.append(float(self._loss(out, labels[0])))
            metric_out = [m.update(m.compute(out, *labels))
                          for m in self._metrics]
        finally:
            self.network.train()
        return res, metric_out

    def predict_batch(self, inputs):
        self.network.eval()
        try:
            with torch.no_grad():
                return self.network(*_as_list(inputs))
        finally:
            self.network.train()

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        from ..io import DataLoader, Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              device=self._device())
        return data

    def _metric_names(self):
        out = []
        for m in self._metrics:
            n = m.name()
            out += n if isinstance(n, list) else [n]
        return out

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = (None if eval_data is None else
                       self._loader(eval_data, batch_size,
                                    num_workers=num_workers))
        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=["loss"] + self._metric_names(),
                            log_freq=log_freq)
        cbks.on_begin("train")
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch, steps)
            for m in self._metrics:
                m.reset()
            it = 0
            logs = {}
            for batch in train_loader:
                cbks.on_batch_begin("train", it, None)
                xs, ys = self._split_batch(batch)
                losses = self.train_batch(xs, ys)
                logs = {"loss": losses[0], "step": it}
                cbks.on_batch_end("train", it, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
        cbks.on_end("train")
        if save_dir:
            self.save(os.path.join(save_dir, "final"))

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._loader(eval_data, batch_size, num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        it = 0
        for batch in loader:
            xs, ys = self._split_batch(batch)
            res, _ = self.eval_batch(xs, ys)
            if res:
                losses.append(res[0])
            it += 1
            if num_iters is not None and it >= num_iters:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            logs.update(zip(names, vals))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, num_workers=num_workers)
        outputs = []
        k = self._n_inputs()
        for batch in loader:
            if isinstance(batch, (list, tuple)):
                xs = (list(batch[:k]) if k is not None and k < len(batch)
                      else list(batch))
            else:
                xs = [batch]
            outputs.append(self.predict_batch(xs))
        if stack_outputs and outputs:
            return [torch.cat(outputs, dim=0)]
        return outputs

    def _n_inputs(self):
        """How many leading batch elements the network takes: the
        declared inputs, else ``forward``'s positional arity (None: all)."""
        if self._inputs is not None:
            return len(_as_list(self._inputs))
        try:
            sig = inspect.signature(self.network.forward)
        except (TypeError, ValueError):
            return None
        n = 0
        for p in sig.parameters.values():
            if p.kind == p.VAR_POSITIONAL:
                return None
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                n += 1
        return n or None

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    # -- io ------------------------------------------------------------------
    def _opt_state_dict(self):
        sd = self._optimizer.state_dict()
        if self._train_step is not None:
            sd.update(self._train_step._state)
        return sd

    def _load_step_opt(self, state):
        """The moments in ``state`` for the train step's parameters,
        copied onto their devices."""
        step = self._train_step
        for k, view in step._views.items():
            if isinstance(state.get(k), dict):
                step._state[k] = {
                    n: (torch.as_tensor(v).detach().to(view.device, copy=True)
                        if isinstance(v, (torch.Tensor, np.ndarray)) else v)
                    for n, v in state[k].items()}
        self._pending_opt = None

    def save(self, path, training=True):
        from ..framework.io import save as psave
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._opt_state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as pload
        state = pload(path + ".pdparams", device=self._device())
        own = self.network.state_dict()
        if skip_mismatch:
            state = {k: v for k, v in state.items()
                     if k in own and tuple(v.shape) == tuple(own[k].shape)}
        with torch.no_grad():
            self.network.load_state_dict(state, strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt = pload(path + ".pdopt", device=self._device())
            sched = self._optimizer._lr_scheduler()
            if sched is not None and "_lr_scheduler" in opt:
                sched.set_state_dict({k: (v.item() if isinstance(
                    v, torch.Tensor) else v)
                    for k, v in opt["_lr_scheduler"].items()})
            self._pending_opt = opt
            if self._train_step is not None:
                self._load_step_opt(opt)

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtype)
