"""The port's high-level API against the JAX package's, on the CPU.

- ``paddle.Model`` on ``tests/test_hapi_io.py``'s MLP (Adam 5e-2,
  ``CrossEntropyLoss``, ``Accuracy``) with ``shuffle=False`` in both
  packages from the same weights: every batch's loss in ``fit``,
  ``evaluate``'s logs and ``predict``'s outputs within 1e-5;
- ``EarlyStopping`` stops both at the same epoch; ``ModelCheckpoint``
  files the port writes load in JAX's ``Model.load`` and the reverse
  (the weights exactly), and ``Model.save`` -> ``Model.load`` restores
  the optimizer's moments in the port;
- ``Accuracy(topk=(1, 5))``, ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` give JAX's numbers on seeded predictions (exactly);
- ``summary`` (its table and counts) and ``flops`` equal JAX's on LeNet
  and ResNet-18;
- ``Model.fit`` on ``BERT_TINY`` classification (rows 1-3 of the kernel
  table on their plain versions here) gives the losses of a direct
  ``make_train_step`` on the same weights and batches, bit for bit, and
  ``Model.predict(stack_outputs=True)`` the eval logits.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
import chip_smoke
import torch_parity as P
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.autograd.tape import functional_mode
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch as pt
from paddle_tpu_torch import callbacks as cb
from paddle_tpu_torch import metric, nn, optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.models.bert import (BERT_TINY,
                                               BertForSequenceClassification)
from paddle_tpu_torch.vision import models

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


class _Synth:
    """``tests/test_hapi_io.py``'s dataset: 64 rows of 8 features, a
    linear two-class label."""

    def __init__(self, n=64):
        rng = np.random.default_rng(0)
        self.x = rng.normal(size=(n, 8)).astype(np.float32)
        self.w = rng.normal(size=(8,)).astype(np.float32)
        self.y = (self.x @ self.w > 0).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class PortSynth(_Synth, Dataset):
    pass


class JaxSynth(_Synth, JDataset):
    pass


def _mlps():
    """(JAX MLP, port MLP) with the same weights (the JAX one's,
    ``paddle.seed(0)``)."""
    jpaddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 2))
    tm = nn.Sequential(nn.Linear(8, 32, device="cpu"), nn.ReLU(),
                       nn.Linear(32, 2, device="cpu"))
    return jm, P.port_copy(lambda: tm, jm)


def _jax_model(net):
    m = jpaddle.Model(net)
    m.prepare(joptim.Adam(learning_rate=5e-2, parameters=net.parameters()),
              jnn.CrossEntropyLoss(), jmetric.Accuracy())
    return m


def _port_model(net):
    m = pt.Model(net)
    m.prepare(optimizer.Adam(learning_rate=5e-2,
                             parameters=net.parameters()),
              nn.CrossEntropyLoss(), metric.Accuracy())
    return m


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.losses, self.epochs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(epoch)
    return Rec()


@pytest.fixture(scope="module")
def fitted():
    """Both packages' models after ``fit(epochs=3, batch_size=16,
    shuffle=False)``, with their recorders."""
    jm, tm = _mlps()
    jmod, tmod = _jax_model(jm), _port_model(tm)
    jrec, trec = _recorder(jcb.Callback), _recorder(cb.Callback)
    jmod.fit(JaxSynth(), epochs=3, batch_size=16, shuffle=False, verbose=0,
             callbacks=[jrec])
    tmod.fit(PortSynth(), epochs=3, batch_size=16, shuffle=False, verbose=0,
             callbacks=[trec])
    return jmod, tmod, jrec, trec


def test_fit_losses_match_jax(fitted):
    _, _, jrec, trec = fitted
    assert len(trec.losses) == len(jrec.losses) == 12
    np.testing.assert_allclose(trec.losses, jrec.losses, **TOL)
    assert trec.losses[-1] < trec.losses[0]


def test_evaluate_logs_match_jax(fitted):
    jmod, tmod, _, _ = fitted
    want = jmod.evaluate(JaxSynth(), batch_size=16, verbose=0)
    got = tmod.evaluate(PortSynth(), batch_size=16, verbose=0)
    assert got.keys() == want.keys() == {"loss", "acc"}
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["acc"] == want["acc"] > 0.8


@pytest.mark.parametrize("stack", [False, True])
def test_predict_matches_jax(fitted, stack):
    jmod, tmod, _, _ = fitted
    want = jmod.predict(JaxSynth(), batch_size=16, stack_outputs=stack)
    got = tmod.predict(PortSynth(), batch_size=16, stack_outputs=stack)
    assert len(got) == len(want) == (1 if stack else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), **TOL)


def test_early_stopping_stops_at_jaxs_epoch():
    jm, tm = _mlps()
    jmod, tmod = _jax_model(jm), _port_model(tm)
    jrec, trec = _recorder(jcb.Callback), _recorder(cb.Callback)
    kw = dict(monitor="loss", patience=1, min_delta=0.05)
    jmod.fit(JaxSynth(), epochs=12, batch_size=16, shuffle=False, verbose=0,
             callbacks=[jcb.EarlyStopping(**kw), jrec])
    tmod.fit(PortSynth(), epochs=12, batch_size=16, shuffle=False,
             verbose=0, callbacks=[cb.EarlyStopping(**kw), trec])
    assert trec.epochs == jrec.epochs
    assert len(trec.epochs) < 12 and tmod.stop_training


def _params(net):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v._data)) for k, v in net.state_dict().items()}


def test_port_checkpoints_load_in_jax(tmp_path):
    jm, tm = _mlps()
    tmod = _port_model(tm)
    tmod.fit(PortSynth(), epochs=2, batch_size=16, shuffle=False, verbose=0,
             callbacks=[cb.ModelCheckpoint(save_dir=str(tmp_path))])
    assert sorted(os.listdir(tmp_path)) == ["0.pdopt", "0.pdparams",
                                            "1.pdopt", "1.pdparams"]
    jmod = _jax_model(jm)
    jmod.load(str(tmp_path / "1"))
    want = _params(tm)
    got = _params(jm)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_jax_checkpoints_load_in_the_port(tmp_path):
    jm, tm = _mlps()
    jmod = _jax_model(jm)
    jmod.fit(JaxSynth(), epochs=2, batch_size=16, shuffle=False, verbose=0,
             callbacks=[jcb.ModelCheckpoint(save_dir=str(tmp_path))])
    tmod = _port_model(tm)
    tmod.load(str(tmp_path / "1"))
    want, got = _params(jm), _params(tm)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_save_load_restores_the_moments(tmp_path):
    """A port ``Model`` saved after a fit and loaded into a fresh one
    takes the same next step (the weights and Adam's moments restored)."""
    _, tm = _mlps()
    a = _port_model(copy.deepcopy(tm))
    a.fit(PortSynth(), epochs=1, batch_size=16, shuffle=False, verbose=0)
    a.save(str(tmp_path / "ck"))
    b = _port_model(copy.deepcopy(tm))
    b.load(str(tmp_path / "ck"))
    batch = PortSynth()[0:16]
    xs, ys = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    assert a.train_batch([xs], [ys]) == b.train_batch([xs], [ys])
    for k, v in _params(a.network).items():
        np.testing.assert_array_equal(_params(b.network)[k], v)


def _preds(seed, n=40, classes=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, classes)).astype(np.float32),
            rng.integers(0, classes, (n, 1)).astype(np.int64))


def test_metrics_match_jax():
    p, y = _preds(0)
    acc, jacc = metric.Accuracy(topk=(1, 5)), jmetric.Accuracy(topk=(1, 5))
    for lo, hi in ((0, 17), (17, 40)):
        got = acc.update(acc.compute(torch.from_numpy(p[lo:hi]),
                                     torch.from_numpy(y[lo:hi])))
        want = jmetric.Accuracy.update(jacc, jacc.compute(
            jpaddle.to_tensor(p[lo:hi]), jpaddle.to_tensor(y[lo:hi])))
        np.testing.assert_array_equal(got, want)
    assert acc.accumulate() == jacc.accumulate()
    assert acc.name() == jacc.name() == ["acc_top1", "acc_top5"]
    rng = np.random.default_rng(1)
    prob = rng.uniform(size=(50, 1)).astype(np.float32)
    lab = rng.integers(0, 2, (50, 1)).astype(np.int64)
    two = np.concatenate([1 - prob, prob], axis=1)
    for make, jmake, pred in ((metric.Precision, jmetric.Precision, prob),
                              (metric.Recall, jmetric.Recall, prob),
                              (metric.Auc, jmetric.Auc, two)):
        m, jm = make(), jmake()
        m.update(torch.from_numpy(pred), torch.from_numpy(lab))
        jm.update(pred, lab)
        assert m.accumulate() == jm.accumulate()
        assert m.name() == jm.name()
    got = metric.accuracy(torch.from_numpy(p), torch.from_numpy(y), k=3)
    want = jmetric.accuracy(jpaddle.to_tensor(p), jpaddle.to_tensor(y), k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


def _jax_flops(net, size):
    """JAX's ``flops`` inside one trace (its eager forward would compile
    every op on its own); the count is read from the shapes."""
    out = {}

    def f():
        with functional_mode():
            out["n"] = jpaddle.flops(net, size)
        return jnp.zeros(())
    jax.jit(f)()
    return out["n"]


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_summary_and_flops_match_jax(name, capsys):
    size = [1, 1, 28, 28] if name == "LeNet" else [1, 3, 32, 32]
    kw = {} if name == "LeNet" else dict(num_classes=10)
    tm = getattr(models, name)(device="cpu", **kw)
    with P.constant_init():
        jm = getattr(jmodels, name)(**kw)
    got = pt.summary(tm, size)
    got_text = capsys.readouterr().out
    want = jpaddle.summary(jm, size)
    want_text = capsys.readouterr().out
    assert got == want
    assert got_text == want_text
    assert pt.Model(tm).summary(size) == want
    assert pt.flops(tm, size) == _jax_flops(jm, size)
    assert tm.training
    if name == "resnet18":      # the figures chip_smoke's phase 25b holds
        assert got["total_params"] == chip_smoke.RESNET18_C10_PARAMS
        assert pt.flops(tm, size) == chip_smoke.RESNET18_C10_FLOPS


def _bert_batches(cfg, n=3, B=4, L=32, classes=3):
    rng = np.random.default_rng(2)
    return [(rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int64),
             rng.integers(0, classes, (B, 1)).astype(np.int64))
            for _ in range(n)]


class _Rows(Dataset):
    """(ids, label) rows, or (ids,) without labels: ``predict`` passes a
    batch whole to a forward that takes that many inputs (BERT's takes
    three), as the JAX package's does."""

    def __init__(self, batches, labels=True):
        self.ids = np.concatenate([b[0] for b in batches])
        self.y = np.concatenate([b[1] for b in batches]) if labels else None

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return (self.ids[i],) if self.y is None else (self.ids[i], self.y[i])


def test_fit_on_bert_is_the_direct_train_step():
    cfg = dataclasses.replace(BERT_TINY, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    pt.seed(0)
    base = BertForSequenceClassification(cfg, num_classes=3, device="cpu")
    batches = _bert_batches(cfg)

    def loss(logits, y):
        return F.cross_entropy(logits.float(), y)

    direct = copy.deepcopy(base)
    step = fleet.make_train_step(
        direct, optimizer.AdamW(1e-3, parameters=direct.parameters()),
        lambda m, x, y: loss(m(x), y))
    want = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
            for x, y in batches]
    net = copy.deepcopy(base)
    model = pt.Model(net)
    model.prepare(optimizer.AdamW(1e-3, parameters=net.parameters()), loss)
    rec = _recorder(cb.Callback)
    model.fit(_Rows(batches), batch_size=4, shuffle=False, verbose=0,
              callbacks=[rec])
    assert rec.losses == want
    for k, v in _params(direct).items():
        np.testing.assert_array_equal(_params(net)[k], v)
    out = model.predict(_Rows(batches, labels=False), batch_size=4,
                        stack_outputs=True)
    net.eval()
    with torch.no_grad():
        ref = net(torch.from_numpy(np.concatenate([b[0] for b in batches])))
    assert torch.equal(out[0], ref)
