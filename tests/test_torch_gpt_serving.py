"""Serving GPT with the PyTorch port's engine against the JAX engine.

``GPT_TINY`` in fp32 is built in the JAX package and carried into the
port through numpy; both engines serve the same workloads and must emit
identical tokens: staggered prompts sharing a system prefix on the paged
layout with both ``flash_decode`` settings (a radix prefix hit), sampled
(top-k / top-p, per-request temperature and seed) with chunked prefill
co-scheduled with decode, the slot layout greedy and sampled, and a pool
small enough to preempt and replay. Engine tokens also equal the port's
``generate()``. A ``max_len`` past GPT's position table is refused on both
sides. The JAX engines' tokens are computed once per module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.serving import Engine, SpecConfig
from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM

V = GPT_TINY.vocab_size
GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)
SAMPLED = dict(do_sample=True, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPT_TINY)
    jm.eval()
    tm = GPTForCausalLM(GPT_TINY, device="cpu")
    tm.eval()
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _rand(rng, n):
    return rng.integers(0, V, (n,)).astype(np.int32)


def _shared_prefix_prompts():
    rng = np.random.default_rng(7)
    sys_p = _rand(rng, 18)
    return [np.concatenate([sys_p, _rand(rng, k)]) for k in (3, 6, 4, 9)]


def _staggered(eng, prompts, n=5, sampled=False):
    """Two requests, two steps, then one request per step; with
    ``sampled``, per-request temperatures and two explicit seeds."""
    kw = ([dict(temperature=0.7, seed=3), dict(temperature=1.3, seed=4),
           dict(temperature=0.9), dict(temperature=1.1)] if sampled
          else [{}] * 4)
    hs = [eng.submit(prompts[0], max_new_tokens=n, **kw[0]),
          eng.submit(prompts[1], max_new_tokens=n, **kw[1])]
    eng.step()
    eng.step()
    for p, k in zip(prompts[2:], kw[2:]):
        hs.append(eng.submit(p, max_new_tokens=n, **k))
        eng.step()
    eng.drain()
    return [list(h.tokens) for h in hs]


def _chunked_prompts():
    rng = np.random.default_rng(3)
    sys_p = _rand(rng, 16)
    return [np.concatenate([sys_p, _rand(rng, k)]) for k in (13, 2, 21, 5)]


def _preempt_prompts():
    rng = np.random.default_rng(4)
    return [_rand(rng, 12) for _ in range(2)]


PREEMPT_GEO = dict(GEO, n_blocks=6, prefix_sharing=False)


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's tokens on each workload (once per module)."""
    jm, _ = models
    out = {}
    for flash in (False, True):
        out["greedy", flash] = _staggered(
            JaxEngine(jm, **GEO, flash_decode=flash), _shared_prefix_prompts())
    out["chunked"] = _staggered(
        JaxEngine(jm, **GEO, **SAMPLED, prefill_chunk=8), _chunked_prompts(),
        n=6, sampled=True)
    out["slot"] = _staggered(JaxEngine(jm, **GEO, kv_layout="slot"),
                             _shared_prefix_prompts())
    out["slot sampled"] = _staggered(
        JaxEngine(jm, **GEO, **SAMPLED, kv_layout="slot"),
        _shared_prefix_prompts(), sampled=True)
    out["preempt"] = [list(h.tokens) for h in JaxEngine(
        jm, **PREEMPT_GEO, **SAMPLED).generate_all(
            _preempt_prompts(), max_new_tokens=16, temperature=0.9)]
    return out


@pytest.mark.parametrize("flash", [False, True])
def test_paged_greedy_with_a_prefix_hit_matches_jax(models, jax_tokens,
                                                     flash):
    _, tm = models
    eng = Engine(tm, **GEO, flash_decode=flash)
    got = _staggered(eng, _shared_prefix_prompts())
    assert got == jax_tokens["greedy", False] == jax_tokens["greedy", True]
    st = eng.stats()
    assert st["prefix_hit_tokens"] > 0 and eng.cache.check_refcounts()
    assert st["flash_decode"] is flash
    assert st["flash_decode_launches"] == 0         # no CUDA launch on CPU
    # the pool is [layers, blocks, block, 4 kv heads = query heads, 32]
    assert tuple(eng.cache.kc.shape[2:]) == (8, 4, 32)


def test_engine_tokens_equal_generate(models):
    _, tm = models
    prompts = _shared_prefix_prompts()
    hs = Engine(tm, **GEO, flash_decode=True).generate_all(
        prompts, max_new_tokens=5)
    for p, h in zip(prompts, hs):
        gen = tm.generate(torch.from_numpy(p[None]), max_new_tokens=5)
        assert gen[0, len(p):].tolist() == list(h.tokens)


@pytest.mark.parametrize("flash", [False, True])
def test_sampled_chunked_prefill_matches_jax(models, jax_tokens, flash):
    """Prompts of 29, 18, 37 and 21 tokens in chunks of 8 beside the
    others' decode, sampled: the JAX engine's tokens, the shared leading
    chunks skipped."""
    _, tm = models
    eng = Engine(tm, **GEO, **SAMPLED, prefill_chunk=8, flash_decode=flash)
    got = _staggered(eng, _chunked_prompts(), n=6, sampled=True)
    assert got == jax_tokens["chunked"]
    st = eng.stats()
    assert st["chunked_prefills"] == 4 and st["chunk_program"]
    assert st["prefix_hit_tokens"] > 0 and eng.cache.check_refcounts()


@pytest.mark.parametrize("sampled", [False, True])
def test_slot_layout_matches_jax_and_paged(models, jax_tokens, sampled):
    _, tm = models
    kw = SAMPLED if sampled else {}
    slot = Engine(tm, **GEO, **kw, kv_layout="slot")
    got = _staggered(slot, _shared_prefix_prompts(), sampled=sampled)
    paged = _staggered(Engine(tm, **GEO, **kw), _shared_prefix_prompts(),
                       sampled=sampled)
    assert got == paged == jax_tokens["slot sampled" if sampled else "slot"]
    assert slot.stats()["kv_layout"] == "slot" and slot.cache.n_free == 2


def test_sampled_preemption_replay_matches_jax(models, jax_tokens):
    """A pool below the combined worst case: the newest request is
    preempted mid-decode and replayed with its key chain fast-forwarded."""
    _, tm = models
    eng = Engine(tm, **PREEMPT_GEO, **SAMPLED, flash_decode=True)
    got = [list(h.tokens) for h in eng.generate_all(
        _preempt_prompts(), max_new_tokens=16, temperature=0.9)]
    assert got == jax_tokens["preempt"]
    assert eng.stats()["preemptions"] >= 1
    assert eng.cache.pool.n_free == 5 and eng.cache.check_refcounts()


def test_max_len_past_the_position_table_is_refused(models):
    jm, tm = models
    P = GPT_TINY.max_position_embeddings
    for E, m in ((JaxEngine, jm), (Engine, tm)):
        with pytest.raises(ValueError, match="position table"):
            E(m, n_slots=2, max_len=P + 1)
        for layout in ("paged", "slot"):
            assert E(m, n_slots=1, kv_layout=layout).max_len == P


def test_out_of_slice_options_still_raise(models):
    _, tm = models
    # tp=2 serves GPT (tests/test_torch_serving_tp.py) and speculative
    # decoding serves it on one rank (tests/test_torch_serving_spec.py);
    # together they are refused, as in JAX, and a speculative= that is not
    # a SpecConfig is a TypeError
    with pytest.raises(ValueError, match="not supported with tp > 1"):
        Engine(tm, **GEO, tp=2, speculative=SpecConfig(),
               mesh=mesh.build_mesh(tp=2, world_size=2, rank=0))
    with pytest.raises(TypeError, match="SpecConfig"):
        Engine(tm, **GEO, speculative=object())
    with pytest.raises(TypeError, match="GPTForCausalLM"):
        Engine(torch.nn.Linear(2, 2), **GEO)
