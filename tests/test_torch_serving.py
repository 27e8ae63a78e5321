"""Serving engine of the PyTorch port against the JAX package.

One tiny fp32 Llama (2 layers, GQA 8/4) is built in the JAX package and
carried into the port through numpy; both engines then serve the same
greedy workloads and must emit identical tokens: staggered prompts with a
shared system prefix (radix sharing, copy-on-write), both
``flash_decode`` settings on both sides, pool-exhaustion preemption with
replay, eos, and a logit mask. The host bookkeeping (BlockPool,
RadixIndex) hands out the same block ids as the JAX classes.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.serving import BlockPool as JaxBlockPool
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import RadixIndex as JaxRadix
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.serving import (BlockPool, Engine, EngineOverloaded,
                                      RadixIndex, RequestCancelled,
                                      SpecConfig)
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")
GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _staggered(eng, prompts, n=5):
    hs = [eng.submit(prompts[0], max_new_tokens=n),
          eng.submit(prompts[1], max_new_tokens=n)]
    eng.step()
    eng.step()
    for p in prompts[2:]:
        hs.append(eng.submit(p, max_new_tokens=n))
        eng.step()
    eng.drain()
    return hs


def _shared_prefix_prompts():
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, CFG.vocab_size, (18,)).astype(np.int32)
    return [np.concatenate(
        [sys_p, rng.integers(0, CFG.vocab_size, (k,)).astype(np.int32)])
        for k in (3, 6, 4, 9)]


@pytest.fixture(scope="module")
def jax_staggered(models):
    """The JAX engine's tokens on the shared-prefix workload, for both
    flash_decode settings (computed once per module)."""
    jm, _ = models
    out = {}
    for flash in (False, True):
        hs = _staggered(JaxEngine(jm, **GEO, flash_decode=flash),
                        _shared_prefix_prompts())
        out[flash] = [list(h.tokens) for h in hs]
    return out


@pytest.mark.parametrize("flash", [False, True])
def test_staggered_shared_prefix_tokens_match_jax(models, jax_staggered,
                                                  flash):
    _, tm = models
    eng = Engine(tm, **GEO, flash_decode=flash)
    hs = _staggered(eng, _shared_prefix_prompts())
    got = [list(h.tokens) for h in hs]
    assert got == jax_staggered[False] == jax_staggered[True]
    st = eng.stats()
    assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0
    assert st["flash_decode"] is flash
    assert st["flash_decode_launches"] == 0         # no CUDA launch on CPU
    assert eng.cache.check_refcounts()
    assert all(h.finish_reason == "length" for h in hs)


def test_preemption_replay_matches_jax(models):
    """A pool below the combined worst case: the newest request is
    preempted mid-decode and replayed; tokens equal the JAX engine's."""
    jm, tm = models
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
               for _ in range(2)]
    geo = dict(GEO, n_blocks=6, prefix_sharing=False)
    want = [list(h.tokens) for h in JaxEngine(jm, **geo).generate_all(
        prompts, max_new_tokens=16)]
    eng = Engine(tm, **geo, flash_decode=True)
    got = [list(h.tokens) for h in eng.generate_all(prompts,
                                                    max_new_tokens=16)]
    assert got == want
    assert eng.stats()["preemptions"] >= 1
    assert eng.cache.pool.n_free == 5 and eng.cache.check_refcounts()


def test_eos_and_logit_mask_match_jax(models):
    jm, tm = models
    rng = np.random.default_rng(5)
    p = rng.integers(0, CFG.vocab_size, (9,)).astype(np.int32)
    free = [list(h.tokens) for h in Engine(tm, **GEO).generate_all(
        [p], max_new_tokens=6)][0]
    eos = free[2]
    mask = (rng.random(CFG.vocab_size) < 0.3).astype(np.float32)
    mask[eos] = 1.0
    results = []
    streamed = []
    for E, m in ((JaxEngine, jm), (Engine, tm)):
        eng = E(m, **GEO, eos_token_id=eos)
        h1 = eng.submit(p, max_new_tokens=6,
                        on_token=lambda h, t: streamed.append(t))
        h2 = eng.submit(p, max_new_tokens=6, logit_mask=mask)
        eng.drain()
        results.append((list(h1.tokens), h1.finish_reason,
                        list(h2.tokens)))
    assert results[0] == results[1]
    assert streamed == results[0][0] + results[1][0]      # streamed in order
    assert results[1][0] == free[:3] and results[1][1] == "eos"
    assert all(mask[t] > 0 for t in results[1][2])


def test_backpressure_and_cancel(models):
    _, tm = models
    rng = np.random.default_rng(6)
    ps = [rng.integers(0, CFG.vocab_size, (5,)).astype(np.int32)
          for _ in range(3)]
    eng = Engine(tm, n_slots=1, max_len=64, min_prompt_bucket=4,
                 block_size=8, max_queue=1)
    h0 = eng.submit(ps[0], max_new_tokens=8)        # admitted
    h1 = eng.submit(ps[1], max_new_tokens=8)        # queued
    with pytest.raises(EngineOverloaded):
        eng.submit(ps[2], max_new_tokens=8)
    assert eng.stats()["requests_rejected"] == 1
    eng.step()
    assert eng.cancel(h0) and eng.cancel(h1) and not eng.cancel(h1)
    with pytest.raises(RequestCancelled):
        h0.result()
    assert eng.cache.n_active == 0 and eng.scheduler.queue_depth == 0
    assert eng.cache.check_refcounts()
    h2 = eng.submit(ps[2], max_new_tokens=3)
    assert len(h2.result()) == 5 + 3


def test_block_pool_and_radix_match_jax_classes():
    """The same unit sequence gives the same block ids, refcounts and
    matches on both sides."""
    toks = np.arange(20, dtype=np.int32)
    got = []
    for Pool, Radix in ((JaxBlockPool, JaxRadix), (BlockPool, RadixIndex)):
        pool, radix = Pool(8), Radix(block_size=4)
        blocks = [pool.alloc() for _ in range(3)]
        radix.insert(toks[:12], blocks, pool)
        pool.deref(blocks[1])
        more = [pool.alloc() for _ in range(4)]
        m = radix.match(np.concatenate([toks[:8], toks[:4]]))
        freed = radix.evict(pool, need=2)
        got.append((blocks, more, m, freed, pool.refcount.tolist(),
                    pool.n_free, radix.n_nodes))
    assert got[0] == got[1]


# speculative decoding serves since it was ported
# (tests/test_torch_serving_spec.py); as in JAX, anything but a SpecConfig
# is a TypeError and tp > 1 a ValueError (a mesh of two ranks that makes no
# process group passes the tp checks)
@pytest.mark.parametrize("kw,error,match", [
    (dict(tp=2, mesh=mesh.build_mesh(tp=2, world_size=2, rank=0),
          speculative=SpecConfig()), ValueError, "not supported with tp > 1"),
    (dict(speculative=object()), TypeError, "SpecConfig")])
def test_out_of_slice_arguments_raise(models, kw, error, match):
    _, tm = models
    with pytest.raises(error, match=match):
        Engine(tm, **GEO, **kw)


def test_adopt_raises(models):
    """``adopt`` (ported since) refuses a handle of an engine with other
    sampling math (``AdoptMismatch``) and, on an engine with tp > 1, names
    the ROADMAP.md item that brings it."""
    from paddle_tpu_torch.serving import AdoptMismatch
    _, tm = models
    eng = Engine(tm, **GEO)
    h = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(AdoptMismatch):
        Engine(tm, **GEO, do_sample=True).adopt(h)
    eng.tp = 2                       # the tp guard, without a process group
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.adopt(h)


def test_deadline_frees_the_slot_and_raises(models):
    """max_time_s covers queueing and decoding: an expired request frees
    its blocks at the next step, result() raises RequestTimeout, and the
    engine keeps serving."""
    import time

    from paddle_tpu_torch.serving import RequestTimeout
    _, tm = models
    eng = Engine(tm, **GEO)
    p = np.arange(7, dtype=np.int32)
    h = eng.submit(p, max_new_tokens=20, max_time_s=0.05)
    eng.step()
    time.sleep(0.06)
    eng.step()
    assert h.finished and h.finish_reason == "timeout"
    with pytest.raises(RequestTimeout):
        h.result()
    assert eng.cache.n_active == 0 and eng.cache.check_refcounts()
    assert eng.stats()["requests_timed_out"] == 1
    assert len(eng.submit(p, max_new_tokens=2).result()) == 9
