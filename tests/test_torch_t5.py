"""T5 on the PyTorch port against the JAX package's, on the CPU.

``T5_TINY`` in fp32 with the relu and the gated-gelu feed-forward, tied
and untied embeddings; the port model's seeded weights carry across to
the JAX model (and the JAX step's initial weights back through
``load_numpy_state_dict``); inputs come from numpy seeds. Held:

- the logits and the label loss (``_shift_right`` of labels with -100
  in them) within ``FWD_TOL`` (1e-5 relative and absolute);
- three fleet + AdamW(1e-3) steps: losses within 2e-4 relative, the
  parameters under ``torch_parity.assert_params_close``;
- greedy ``generate`` token-identical to JAX's, without an
  ``eos_token_id`` and (untied, where the random models' tokens vary)
  with one that a row emits part-way, so rows stop at different steps
  and then keep emitting it;
- the relative-position buckets equal to JAX's ``_rel_bucket`` for every
  relative position of lengths 1..2048 in both directions, and whole
  tables at lengths where the formula lands on an integer;
- planted faults that must fail: the scores scaled by ``1 / sqrt(d_kv)``
  (q's weight scaled), and the decoder's buckets made bidirectional.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_parity as P
from paddle_tpu.text.models import t5 as jt5
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text.models import t5

CONFIGS = {f"{ff}-{'tied' if tie else 'untied'}": dataclasses.replace(
    jt5.T5_TINY, feed_forward_proj=ff, tie_word_embeddings=tie)
    for ff in ("relu", "gated-gelu") for tie in (True, False)}
B, LS, LT = 3, 10, 8
NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


def _pcfg(cfg):
    return t5.T5Config(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def models():
    """name -> (JAX T5ForConditionalGeneration holding the port's
    weights, the port's model: seed i)."""
    out = {}
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        pt.seed(i)
        tm = t5.T5ForConditionalGeneration(_pcfg(cfg), device="cpu")
        out[name] = (P.jax_copy(
            lambda: jt5.T5ForConditionalGeneration(cfg), tm), tm)
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    src = rng.integers(2, 256, (B, LS)).astype(np.int64)
    tgt = rng.integers(2, 256, (B, LT)).astype(np.int64)
    tgt[1, -3:] = -100                          # ignored label positions
    return dict(src=src, tgt=tgt)


def _i32(x):
    return x.astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_and_label_loss(models, data, name):
    jm, tm = models[name]
    dec = np.random.default_rng(7).integers(0, 256, (B, LT))
    want_logits, want_loss = P.jax_call(
        lambda s, d, y: (jm(s, decoder_input_ids=d), jm(s, labels=y)),
        _i32(data["src"]), _i32(dec), _i32(data["tgt"]))
    with torch.no_grad():
        logits = tm(data["src"], decoder_input_ids=dec)
        loss = tm(data["src"], labels=data["tgt"])
    assert P.arrays(tm).keys() == P.arrays(jm).keys()
    np.testing.assert_allclose(logits.numpy(), want_logits, **P.FWD_TOL)
    np.testing.assert_allclose(loss.item(), want_loss, **P.FWD_TOL)


def _loss(m, src, tgt):
    return m(src, labels=tgt)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_fleet_adamw_steps_match_jax(models, data, name):
    import copy
    jm, _ = models[name]
    init, want_losses, want = P.jax_train(
        copy.deepcopy(jm), _loss, _i32(data["src"]), _i32(data["tgt"]))
    model = t5.T5ForConditionalGeneration(_pcfg(CONFIGS[name]),
                                          device="cpu")
    load_numpy_state_dict(model, init)
    losses, got = P.port_train(model, _loss, data["src"], data["tgt"])
    np.testing.assert_allclose(losses, want_losses, rtol=P.LOSS_RTOL)
    assert losses[2] < losses[0]
    P.assert_params_close(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_is_token_identical_to_jax(models, name):
    import paddle_tpu as paddle
    jm, tm = models[name]
    src = np.random.default_rng(6).integers(2, 256, (B, LS))
    want = np.asarray(jm.generate(paddle.to_tensor(_i32(src)),
                                  max_new_tokens=NEW,
                                  eos_token_id=None)._data)
    got = tm.generate(src, max_new_tokens=NEW, eos_token_id=None)
    assert got.shape == (B, NEW + 1) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if name.endswith("-tied"):
        # random tied embeddings emit token 0 throughout (the residual
        # stream carries the start token's embedding): no eos case there
        assert (want[:, 1:] == 0).all()
        return
    # an eos that row 0 emits part-way, so the rows stop at other steps
    eos = int(want[0, NEW // 2])
    want = np.asarray(jm.generate(paddle.to_tensor(_i32(src)),
                                  max_new_tokens=NEW,
                                  eos_token_id=eos)._data)
    got = tm.generate(src, max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    hit = np.argmax(want[0, 1:] == eos) + 1
    assert (want[0, hit:] == eos).all()


def test_generate_matches_an_incremental_greedy_loop(models):
    """JAX's own check (``tests/test_hf_interop.py``) on the port: the
    padded-buffer decode equals re-running on the growing prefix."""
    _, tm = models["relu-untied"]
    src = np.random.default_rng(6).integers(2, 256, (2, LS))
    dec = np.zeros((2, 1), np.int64)
    with torch.no_grad():
        for _ in range(5):
            logits = tm(src, decoder_input_ids=dec)
            nxt = logits[:, -1].argmax(-1).numpy()
            dec = np.concatenate([dec, nxt[:, None]], axis=1)
    got = tm.generate(src, max_new_tokens=5, eos_token_id=None).numpy()
    np.testing.assert_array_equal(got, dec)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_equal_jax_for_lengths_up_to_2048(bidirectional):
    """Every relative position of lengths 1..2048 (-2047..2047) against
    JAX's ``_rel_bucket``; whole tables against JAX's elementwise rule
    (entry (i, j) is the bucket of j - i) at lengths where the formula
    lands on an integer and around them."""
    import jax.numpy as jnp
    c = jt5.T5_TINY
    args = (bidirectional, c.relative_attention_num_buckets,
            c.relative_attention_max_distance)
    rel = np.arange(-2047, 2048, dtype=np.int32)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel), *args))
    got = t5._rel_bucket(torch.from_numpy(rel), *args).numpy()
    np.testing.assert_array_equal(got, want)
    for n in (1, 16, 17, 32, 64, 128, 513, 2048):
        i, j = np.arange(n)[:, None], np.arange(n)[None, :]
        table = t5._bucket_table(n, n, *args, torch.device("cpu"))
        np.testing.assert_array_equal(table.numpy(), want[j - i + 2047])


def test_planted_faults_fail(models, data):
    """The score scaled by 1 / sqrt(d_kv), and bidirectional buckets in
    the decoder, must each break the logits' check."""
    jm, _ = models["gated-gelu-untied"]
    cfg = CONFIGS["gated-gelu-untied"]
    # 24 decoder positions: below 10 the two directions' buckets agree
    # on every key the causal mask keeps
    dec = np.random.default_rng(7).integers(0, 256, (B, 24))
    want = P.jax_call(lambda s, d: jm(s, decoder_input_ids=d),
                      _i32(data["src"]), _i32(dec))
    tm = P.port_copy(lambda: t5.T5ForConditionalGeneration(
        _pcfg(cfg), device="cpu"), jm)
    with torch.no_grad():
        got = tm(data["src"], decoder_input_ids=dec).numpy()
    np.testing.assert_allclose(got, want, **P.FWD_TOL)

    def faulty(fault):
        tm = P.port_copy(lambda: t5.T5ForConditionalGeneration(
            _pcfg(cfg), device="cpu"), jm)
        for stack in (tm.t5.encoder, tm.t5.decoder):
            for blk in stack.blocks:
                if fault == "scaled":
                    with torch.no_grad():
                        blk.self_attn.q.weight.mul_(cfg.d_kv ** -0.5)
                elif stack is tm.t5.decoder:
                    blk.self_attn.bidirectional = True
        with torch.no_grad():
            return tm(data["src"], decoder_input_ids=dec).numpy()

    for fault in ("scaled", "bidirectional decoder"):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(faulty(fault), want, **P.FWD_TOL)
