"""BERT on the PyTorch port against the JAX package's, on the CPU.

``BERT_TINY`` with dropout 0 (the port's dropout draws are not JAX's);
the port model's seeded weights carry across to the JAX model (and the
JAX step's initial weights back through ``load_numpy_state_dict``);
inputs come from numpy seeds. Tolerances:

- forwards (``seq``, ``pooled``, the pretraining logits, the
  classification logits, the loss) in fp32 within ``FWD_TOL`` (1e-5
  relative and absolute): with and without ``token_type_ids`` and a 2-D
  padding mask, which both packages turn into the additive
  ``(1 - m) * -1e30`` mask;
- the pretraining loss with 15% MLM labels (-100 elsewhere) and NSP
  labels;
- three fleet + AdamW(1e-3) steps: losses within 2e-4 relative, the
  parameters under ``torch_parity.assert_params_close`` (the rule of
  ``tests/test_torch_gpt_train.py``: rtol 2e-4 but for 0.1% of the
  elements, none beyond 6 lr; the key biases, whose true gradient is
  zero under softmax, within 6 lr alone);
- planted faults that must fail the same checks: the heads'
  ``LayerNorm`` at ``layer_norm_eps`` (1e-12) instead of its default
  1e-5, and a 2-D mask read as keep-where-zero.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_parity as P
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.text.models import bert

CFG = dataclasses.replace(jbert.BERT_TINY, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
PCFG = bert.BertConfig(**dataclasses.asdict(CFG))
B, L = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.vocab_size, (B, L)).astype(np.int64)
    tt = rng.integers(0, CFG.type_vocab_size, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, 20:] = 0
    mlm = np.where(rng.random((B, L)) < 0.15, ids, -100).astype(np.int64)
    mlm[0, 0] = ids[0, 0]                       # at least one kept label
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return dict(ids=ids, tt=tt, mask=mask, mlm=mlm, nsp=nsp)


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def pretrain():
    """(JAX BertForPretraining holding the port's weights, the port's
    model: seed 0)."""
    pt.seed(0)
    tm = bert.BertForPretraining(PCFG, device="cpu")
    return P.jax_copy(lambda: jbert.BertForPretraining(CFG), tm), tm


def _i32(x):
    return None if x is None else x.astype(np.int32)


def _port(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_tt", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_model_seq_and_pooled(pretrain, data, with_tt, with_mask):
    jm, tm = pretrain
    tt = data["tt"] if with_tt else None
    mask = data["mask"] if with_mask else None
    want = P.jax_call(lambda i, t, m: jm.bert(i, t, attention_mask=m),
                      _i32(data["ids"]), _i32(tt), _i32(mask))
    with torch.no_grad():
        got = tm.bert(_port(data["ids"]), _port(tt),
                      attention_mask=_port(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **P.FWD_TOL)


def test_pretraining_logits_and_loss(pretrain, data):
    jm, tm = pretrain
    d = data
    (want_pred, want_rel), want_loss, want_mlm = P.jax_call(
        lambda i, t, m, y, n: (
            jm(i, t, attention_mask=m),
            jm(i, t, attention_mask=m, masked_lm_labels=y,
               next_sentence_label=n),
            jm(i, masked_lm_labels=y)),
        *(_i32(d[k]) for k in ("ids", "tt", "mask", "mlm", "nsp")))
    with torch.no_grad():
        pred, rel = tm(d["ids"], d["tt"], attention_mask=d["mask"])
        loss = tm(d["ids"], d["tt"], attention_mask=d["mask"],
                  masked_lm_labels=d["mlm"], next_sentence_label=d["nsp"])
        mlm = tm(d["ids"], masked_lm_labels=d["mlm"])
    np.testing.assert_allclose(pred.numpy(), want_pred, **P.FWD_TOL)
    np.testing.assert_allclose(rel.numpy(), want_rel, **P.FWD_TOL)
    np.testing.assert_allclose(loss.item(), want_loss, **P.FWD_TOL)
    np.testing.assert_allclose(mlm.item(), want_mlm, **P.FWD_TOL)
    assert loss.dtype == torch.float32 and loss.item() > mlm.item() - 1


def test_sequence_classification_logits(data):
    pt.seed(1)
    tc = bert.BertForSequenceClassification(PCFG, num_classes=3,
                                            device="cpu")
    jc = P.jax_copy(lambda: jbert.BertForSequenceClassification(
        CFG, num_classes=3), tc)
    assert P.arrays(tc).keys() == P.arrays(jc).keys()
    want = P.jax_call(lambda i, t, m: jc(i, t, attention_mask=m),
                      _i32(data["ids"]), _i32(data["tt"]),
                      _i32(data["mask"]))
    with torch.no_grad():
        got = tc(data["ids"], data["tt"], attention_mask=data["mask"])
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)


def _loss(m, ids, tt, mask, mlm, nsp):
    return m(ids, tt, attention_mask=mask, masked_lm_labels=mlm,
             next_sentence_label=nsp)


@pytest.fixture(scope="module")
def jax_steps(pretrain, data):
    return P.jax_train(copy.deepcopy(pretrain[0]), _loss,
                       *(_i32(data[k]) for k in ("ids", "tt", "mask", "mlm",
                                                 "nsp")))


def test_three_fleet_adamw_steps_match_jax(jax_steps, data):
    init, want_losses, want = jax_steps
    model = bert.BertForPretraining(PCFG, device="cpu")
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    load_numpy_state_dict(model, init)
    losses, got = P.port_train(model, _loss, *(data[k] for k in (
        "ids", "tt", "mask", "mlm", "nsp")))
    np.testing.assert_allclose(losses, want_losses, rtol=P.LOSS_RTOL)
    assert losses[2] < losses[0]
    P.assert_params_close(got, want, exempt=("k_proj.bias",))


def test_planted_faults_fail(pretrain, data):
    """The heads' LayerNorm at 1e-12 and a mask read the wrong way round
    must each break the pretraining logits' check."""
    jm, tm = pretrain
    d = data
    want = P.jax_call(lambda i, t, m: jm(i, t, attention_mask=m)[0],
                      _i32(d["ids"]), _i32(d["tt"]), _i32(d["mask"]))
    ln = tm.cls.layer_norm
    ln.epsilon = CFG.layer_norm_eps
    try:
        with torch.no_grad():
            got = tm(d["ids"], d["tt"], attention_mask=d["mask"])[0]
    finally:
        ln.epsilon = 1e-5
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)
    with torch.no_grad():
        got = tm(d["ids"], d["tt"], attention_mask=1 - d["mask"])[0]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)


def test_defaults_and_state_dict_keys(pretrain, data):
    """Default ids equal the explicit ``arange`` positions and zero token
    types; the keys are the JAX model's; the decoder is not tied."""
    jm, tm = pretrain
    assert P.arrays(tm).keys() == P.arrays(jm).keys()
    assert tm.cls.decoder.weight.data_ptr() != \
        tm.bert.embeddings.word_embeddings.weight.data_ptr()
    ids = torch.from_numpy(data["ids"])
    with torch.no_grad():
        a = tm.bert(ids)[0]
        b = tm.bert(ids, torch.zeros_like(ids),
                    torch.arange(L)[None].expand(B, L))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
