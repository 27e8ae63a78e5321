"""Beam search and ``init_cache`` in the PyTorch port against the JAX
package.

The tiny fp32 Llama (2 layers) is built in the JAX package and carried
into the port through numpy. ``generate(num_beams=K)`` must give JAX's
``beam_search_generate`` tokens for 2 and 4 beams, with and without an
eos token that the beams reach, at length penalties 1.0 and 0.6; one beam
is greedy ``generate``; the beam's sequence log-prob is at least
greedy's (JAX's ``test_generation.py`` check); ``init_cache`` gives
JAX's shapes and dtypes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.generation import beam_search_generate as jax_beam
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text.generation import beam_search_generate
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts():
    rng = np.random.default_rng(4)
    return rng.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)


def _jax(jm, ids, **kw):
    return np.asarray(jax_beam(jm, paddle.to_tensor(ids),
                               max_new_tokens=MAX_NEW, **kw)._data)


@pytest.fixture(scope="module")
def eos_free(models):
    """Per beam count, JAX's tokens without eos."""
    jm, _ = models
    return {k: _jax(jm, _prompts(), num_beams=k) for k in (2, 4)}


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("num_beams", [2, 4])
def test_beam_search_matches_jax(models, eos_free, num_beams, with_eos,
                                 length_penalty):
    """With eos, the eos is the third new token of the eos-free winner of
    row 0: its beam finishes there and freezes (extending only with eos,
    at -1e9 on every other token: ties), so row 0 comes out otherwise."""
    jm, tm = models
    ids = _prompts()
    free = eos_free[num_beams]
    kw = dict(num_beams=num_beams, length_penalty=length_penalty,
              eos_token_id=int(free[0, 6 + 2]) if with_eos else None)
    want = _jax(jm, ids, **kw)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=MAX_NEW, **kw)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if with_eos:
        assert not np.array_equal(want[0], free[0])


def test_one_beam_is_greedy(models):
    _, tm = models
    ids = torch.from_numpy(_prompts())
    greedy = tm.generate(ids, max_new_tokens=MAX_NEW)
    assert torch.equal(tm.generate(ids, max_new_tokens=MAX_NEW, num_beams=1),
                       greedy)
    assert torch.equal(beam_search_generate(tm, ids, max_new_tokens=MAX_NEW,
                                            num_beams=1), greedy)


def _seq_logprob(tm, full, prompt_len):
    """Sum of log p(token_t | prefix) over the generated tokens, fp64."""
    with torch.inference_mode():
        logits = tm(torch.as_tensor(full)).double()
    logp = torch.log_softmax(logits, dim=-1)
    return sum(float(logp[0, t - 1, full[0, t]])
               for t in range(prompt_len, full.shape[1]))


def test_beam_search_beats_or_matches_greedy(models):
    _, tm = models
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (1, 6)))
    greedy = tm.generate(prompt, max_new_tokens=5)
    beam = tm.generate(prompt, max_new_tokens=5, num_beams=4)
    assert beam.shape == greedy.shape
    assert _seq_logprob(tm, beam, 6) >= _seq_logprob(tm, greedy, 6) - 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    jc = dataclasses.replace(JAX_TINY, dtype=dtype)
    tc = dataclasses.replace(LLAMA_TINY, dtype=dtype)
    want = JaxLlama(jc).init_cache(3)
    got = LlamaForCausalLM(tc, device="cpu").init_cache(3)
    assert len(got) == len(want) == tc.num_hidden_layers
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w._data.dtype)
