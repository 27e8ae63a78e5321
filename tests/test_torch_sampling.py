"""Sampling filters and batch ``generate()`` of the PyTorch port against
the JAX package.

``_filter_logits`` (temperature, top-k with its ties kept, the top-p
nucleus with the arg-max always kept) must cut the same logits to -inf as
the JAX function and leave the others within 1e-6. ``generate()`` on a
tiny fp32 Llama (2 layers, GQA 8/4) built in the JAX package and carried
across through numpy must emit the JAX tokens exactly: greedy and sampled
(top-k, top-p), with and without right-padded prompts, and with an eos.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text import generation as JG
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text import generation as G
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _logits(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((4, 300)) * 2).astype(np.float32)
    lg[0, rng.choice(300, 100, replace=False)] = -np.inf   # masked vocab
    lg[1, :20] = lg[1].max() + 1                   # a 20-way tie at the top
    return lg


@pytest.mark.parametrize("do_sample,top_k,top_p,per_row", list(
    itertools.product([False, True], [0, 1, 8], [None, 0.0, 0.5, 0.9],
                      [False, True])))
def test_filter_logits_matches_jax(do_sample, top_k, top_p, per_row):
    lg = _logits(top_k * 7 + (0 if top_p is None else int(top_p * 10)))
    temp = (np.array([0.6, 1.0, 1.7, 1e-9], np.float32) if per_row
            else np.float32(0.8))
    got = G._filter_logits(torch.from_numpy(lg), torch.as_tensor(temp),
                           do_sample, top_k, top_p).numpy()
    want = np.asarray(JG._filter_logits(jnp.asarray(lg), jnp.asarray(temp),
                                        do_sample, top_k, top_p))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    if do_sample and top_k == 1 and top_p is None:
        assert np.isfinite(got[1]).sum() == 20     # ties at the k-th stay


@pytest.mark.parametrize("pad", [None, 0])
def test_prompt_mask_matches_jax(pad):
    ids = np.array([[5, 6, 0, 7, 0, 0], [1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0,
                                                             0]], np.int32)
    got = G._prompt_mask(torch.from_numpy(ids), pad, None).numpy()
    want = np.asarray(JG._prompt_mask(jnp.asarray(ids), pad, None))
    np.testing.assert_array_equal(got, want)
    am = (np.arange(6)[None] < np.array([[3], [6], [1]])).astype(np.int32)
    np.testing.assert_array_equal(
        G._prompt_mask(torch.from_numpy(ids), pad, am).numpy(), am)


def _prompts(padded):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, CFG.vocab_size, (3, 9)).astype(np.int32)
    if padded:
        ids[1, 6:] = 0
        ids[2, 4:] = 0
    return ids


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(do_sample=True, top_k=8, temperature=0.8, seed=3),
    dict(do_sample=True, top_p=0.9, seed=5)], ids=["greedy", "top_k",
                                                   "top_p"])
def test_generate_matches_jax(models, kw, padded):
    jm, tm = models
    ids = _prompts(padded)
    pad = dict(pad_token_id=0) if padded else {}
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=7,
                                  **kw, **pad)._data)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=7, **kw, **pad)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_with_eos_and_attention_mask_matches_jax(models):
    jm, tm = models
    ids = _prompts(True)
    am = (ids != 0).astype(np.int32)
    free = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=6,
                                  attention_mask=am)._data)
    eos = int(free[0, 11])
    kw = dict(max_new_tokens=6, eos_token_id=eos, attention_mask=am)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._data)
    got = G.generate(tm, torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 12:] == eos).all()          # eos repeats once reached


def test_beam_search_is_not_in_the_slice(models):
    """Beam search is ported (tests/test_torch_beam_search.py holds it to
    JAX's): ``generate(num_beams=2)`` runs and returns [B, L0 +
    max_new]."""
    _, tm = models
    got = tm.generate(torch.zeros((1, 4), dtype=torch.long), num_beams=2,
                      max_new_tokens=3)
    assert got.dtype == torch.int64 and tuple(got.shape) == (1, 7)


def test_generate_refuses_zero_new_tokens_as_jax_does(models):
    """``max_new_tokens=0``: the JAX package's first token has nowhere to
    go (``IndexError``); the port refuses it up front (``ValueError``)
    instead of returning a token nobody asked for."""
    jm, tm = models
    ids = _prompts(False)
    with pytest.raises(IndexError):
        jm.generate(paddle.to_tensor(ids), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(torch.from_numpy(ids), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        G.generate(tm, torch.from_numpy(ids), max_new_tokens=-1)
