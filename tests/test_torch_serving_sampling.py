"""Sampled, chunked and slot-layout serving of the PyTorch port against the
JAX engine.

One tiny fp32 Llama (2 layers, GQA 8/4) is built in the JAX package and
carried into the port through numpy. Both engines serve the same
workloads and must emit identical tokens: sampled (top-k with a
per-request temperature and seed, top-p) on the paged layout with both
``flash_decode`` settings, preemption replay under sampling, chunked
prefill co-scheduled with decode (a shared leading chunk skipped, cancel
and timeout part-way through the chunks), and the slot layout, greedy and
sampled. A sampled request gives the same tokens alone as among others,
and the same as ``generate(seed=...)``.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")
GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)
TOP_K = dict(do_sample=True, top_k=8)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _rand(rng, n):
    return rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)


def _shared_prefix_prompts():
    rng = np.random.default_rng(7)
    sys_p = _rand(rng, 18)
    return [np.concatenate([sys_p, _rand(rng, k)]) for k in (3, 6, 4, 9)]


def _staggered(eng, prompts, n=5):
    """Two requests, two steps, then one request per step; per-request
    temperatures, two explicit seeds and two default ones."""
    kw = [dict(temperature=0.7, seed=3), dict(temperature=1.3, seed=4),
          dict(temperature=0.9), dict(temperature=1.1)]
    hs = [eng.submit(prompts[0], max_new_tokens=n, **kw[0]),
          eng.submit(prompts[1], max_new_tokens=n, **kw[1])]
    eng.step()
    eng.step()
    for p, k in zip(prompts[2:], kw[2:]):
        hs.append(eng.submit(p, max_new_tokens=n, **k))
        eng.step()
    eng.drain()
    return [list(h.tokens) for h in hs]


@pytest.fixture(scope="module")
def jax_sampled(models):
    """The JAX engine's tokens on the sampled shared-prefix workload, for
    both flash_decode settings (computed once per module)."""
    jm, _ = models
    return {flash: _staggered(JaxEngine(jm, **GEO, **TOP_K,
                                        flash_decode=flash),
                              _shared_prefix_prompts())
            for flash in (False, True)}


@pytest.mark.parametrize("flash", [False, True])
def test_sampled_staggered_shared_prefix_matches_jax(models, jax_sampled,
                                                     flash):
    _, tm = models
    eng = Engine(tm, **GEO, **TOP_K, flash_decode=flash)
    got = _staggered(eng, _shared_prefix_prompts())
    assert got == jax_sampled[False] == jax_sampled[True]
    st = eng.stats()
    assert st["prefix_hit_tokens"] > 0 and eng.cache.check_refcounts()
    assert st["flash_decode_launches"] == 0         # no CUDA launch on CPU


def test_a_sampled_request_does_not_depend_on_its_neighbours(models):
    """Alone, among other traffic, and through ``generate(seed=...)``:
    the same tokens, equal to the JAX engine's."""
    jm, tm = models
    rng = np.random.default_rng(2)
    p, noise = _rand(rng, 6), [_rand(rng, 4), _rand(rng, 7)]
    alone = Engine(tm, n_slots=2, max_len=64, min_prompt_bucket=4, **TOP_K)
    h_alone = alone.submit(p, max_new_tokens=5, temperature=0.8, seed=11)
    alone.drain()
    assert h_alone.seed == 11
    got = []
    for E, m in ((Engine, tm), (JaxEngine, jm)):
        eng = E(m, n_slots=2, max_len=64, min_prompt_bucket=4, **TOP_K)
        eng.submit(noise[0], max_new_tokens=7, temperature=1.4, seed=99)
        h = eng.submit(p, max_new_tokens=5, temperature=0.8, seed=11)
        eng.step()
        eng.submit(noise[1], max_new_tokens=3, temperature=0.6, seed=5)
        eng.drain()
        got.append(list(h.tokens))
    assert got[0] == got[1] == list(h_alone.tokens)
    gen = tm.generate(torch.from_numpy(p[None]), max_new_tokens=5,
                      temperature=0.8, seed=11, **TOP_K)
    assert gen[0, 6:].tolist() == got[0]


def test_top_p_matches_jax(models):
    jm, tm = models
    kw = dict(do_sample=True, top_p=0.9)
    want = _staggered(JaxEngine(jm, **GEO, **kw), _shared_prefix_prompts())
    got = _staggered(Engine(tm, **GEO, **kw, flash_decode=True),
                     _shared_prefix_prompts())
    assert got == want


def test_sampled_preemption_replay_matches_jax(models):
    """A pool below the combined worst case: the newest request is
    preempted mid-decode and replayed with its key chain fast-forwarded;
    the tokens equal the JAX engine's."""
    jm, tm = models
    rng = np.random.default_rng(4)
    prompts = [_rand(rng, 12) for _ in range(2)]
    geo = dict(GEO, n_blocks=6, prefix_sharing=False, **TOP_K)
    want = [list(h.tokens) for h in JaxEngine(jm, **geo).generate_all(
        prompts, max_new_tokens=16, temperature=0.9)]
    eng = Engine(tm, **geo, flash_decode=True)
    got = [list(h.tokens) for h in eng.generate_all(
        prompts, max_new_tokens=16, temperature=0.9)]
    assert got == want
    assert eng.stats()["preemptions"] >= 1
    assert eng.cache.pool.n_free == 5 and eng.cache.check_refcounts()


def _chunked(E, m, flash):
    rng = np.random.default_rng(3)
    long_p, short_p = _rand(rng, 29), _rand(rng, 5)
    kw = dict(flash_decode=flash) if E is Engine else {}
    eng = E(m, **GEO, **TOP_K, prefill_chunk=8, **kw)
    progress = []
    hshort = eng.submit(short_p, max_new_tokens=8, temperature=0.9,
                        on_token=lambda h, t: progress.append("short"))
    hlong = eng.submit(long_p, max_new_tokens=4, temperature=0.9,
                       on_token=lambda h, t: progress.append("long"))
    eng.drain()
    st = eng.stats()
    return (list(hshort.tokens), list(hlong.tokens), st["chunked_prefills"],
            st["chunk_steps"]), progress, eng, (short_p, long_p)


@pytest.fixture(scope="module")
def jax_chunked(models):
    return _chunked(JaxEngine, models[0], False)[0]


@pytest.mark.parametrize("flash", [False, True])
def test_chunked_prefill_coscheduled_with_decode_matches_jax(
        models, jax_chunked, flash):
    """A 29-token prompt prefills in chunks of 8 while a 5-token request
    decodes: the tokens and the chunk counters equal the JAX engine's, the
    short request decodes at least 3 tokens before the long one's first
    token, and both equal ``generate()``'s."""
    _, tm = models
    got, progress, eng, (short_p, long_p) = _chunked(Engine, tm, flash)
    assert got == jax_chunked
    assert got[2:] == (1, 4)
    assert progress.index("long") >= 4          # the short's first + 3
    st = eng.stats()
    assert st["chunk_program"] and st["prefill_buckets"] == [8]
    assert st["prefill_chunk"] == 8 and eng.cache.check_refcounts()
    for p, toks, n in ((short_p, got[0], 8), (long_p, got[1], 4)):
        gen = tm.generate(torch.from_numpy(p[None]), max_new_tokens=n,
                          temperature=0.9, seed=eng.base_seed
                          + (0 if p is short_p else 1), **TOP_K)
        assert gen[0, len(p):].tolist() == toks


def test_chunked_matches_one_shot_prefill(models):
    """Greedy: chunked prefill gives the one-shot prefill's tokens."""
    _, tm = models
    rng = np.random.default_rng(8)
    prompts = [_rand(rng, n) for n in (29, 17, 5)]
    toks = [[list(h.tokens) for h in Engine(tm, **GEO, **kw).generate_all(
        prompts, max_new_tokens=6)] for kw in ({}, dict(prefill_chunk=8))]
    assert toks[0] == toks[1]


def test_a_shared_leading_chunk_is_skipped(models):
    """A second request sharing three full blocks of the first one's
    prompt starts its chunks past them: fewer chunk steps, the same
    tokens and counters as the JAX engine."""
    jm, tm = models
    rng = np.random.default_rng(9)
    sys_p = _rand(rng, 24)
    a, b = (np.concatenate([sys_p, _rand(rng, n)]) for n in (5, 9))
    out = []
    for E, m in ((JaxEngine, jm), (Engine, tm)):
        eng = E(m, **GEO, **TOP_K, prefill_chunk=8)
        ha = eng.submit(a, max_new_tokens=3)
        eng.drain()                        # a's blocks are in the radix
        steps_a = eng.stats()["chunk_steps"]
        hb = eng.submit(b, max_new_tokens=3)
        eng.drain()
        st = eng.stats()
        out.append((list(ha.tokens), list(hb.tokens), steps_a,
                    st["chunk_steps"], st["prefix_hit_tokens"]))
    assert out[0] == out[1]
    _, _, steps_a, steps, hit = out[1]
    assert steps_a == 4 and steps - steps_a == 2 and hit == 24


@pytest.mark.parametrize("how", ["cancel", "timeout"])
def test_cancel_and_timeout_mid_chunk_free_every_block(models, how):
    _, tm = models
    rng = np.random.default_rng(5)
    eng = Engine(tm, **GEO, **TOP_K, prefill_chunk=8, prefix_sharing=False)
    base_free = eng.cache.pool.n_free
    short = eng.submit(_rand(rng, 5), max_new_tokens=12)
    for i in range(2):
        kw = dict(max_time_s=0.5) if how == "timeout" else {}
        h = eng.submit(_rand(rng, 25), max_new_tokens=6, **kw)
        eng.step()                          # one chunk written
        assert not h.finished and h.slot is not None and eng._chunking
        if how == "cancel":
            assert eng.cancel(h)
        else:
            time.sleep(0.55)
            eng.step()                      # the deadline fires mid-chunk
            assert h.finish_reason == "timeout"
        assert not eng._chunking and eng.cache.check_refcounts()
    eng.drain()
    assert short.finish_reason == "length" and len(short.tokens) == 12
    assert eng.cache.pool.n_free == base_free and eng.cache.n_free == 2
    assert eng.cache.check_refcounts()


@pytest.mark.parametrize("kw", [{}, TOP_K], ids=["greedy", "sampled"])
def test_slot_layout_matches_jax_and_paged(models, kw):
    jm, tm = models
    want = _staggered(JaxEngine(jm, **GEO, **kw, kv_layout="slot"),
                      _shared_prefix_prompts())
    slot = Engine(tm, **GEO, **kw, kv_layout="slot")
    got = _staggered(slot, _shared_prefix_prompts())
    paged = _staggered(Engine(tm, **GEO, **kw), _shared_prefix_prompts())
    assert got == want == paged
    st = slot.stats()
    assert st["kv_layout"] == "slot" and not st["prefix_sharing"]
    assert st["kv_cache_bytes"] == 2 * 2 * 2 * 64 * 4 * 32 * 4
    assert slot.cache.n_free == 2


def test_bad_combinations_raise(models):
    _, tm = models
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, **GEO, kv_layout="slot", flash_decode=True)
    for chunk in (12, 4):                   # not a multiple; below a block
        with pytest.raises(ValueError, match="block-aligned"):
            Engine(tm, **GEO, prefill_chunk=chunk)
