"""Speculative decoding in the PyTorch port against the JAX engine.

The tiny fp32 Llama (2 layers, GQA 8/4) and GPT are built in the JAX
package and carried into the port through numpy. ``_spec_verify_impl``
alone equals JAX's on one pool, table row, ids and key: samples and key
words exactly, the pools within 1e-5 relative, the lines past the draft's
width untouched. Driven through ``Engine(speculative=SpecConfig(...))``
on the JAX test's geometry and traffic (``_mixed_reqs``: two vocab-masked
repetitive requests, on which n-grams match, and two random ones), the
port emits the JAX speculative engine's tokens and counters, which are
the JAX plain engine's tokens, in every arm: n-gram greedy and sampled, a
self-draft, the hostile custom proposer, and a tight pool (prefix hit and
preemption); GPT in the n-gram and model-draft arms. The JAX test file's
own checks are ported, and three planted faults in the accept/rewind
step must each break the identity. The JAX engines' results are computed
once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SpecConfig as JaxSpec
from paddle_tpu.serving import engine as jeng
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.serving import Engine, SpecConfig
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.text import generation as G
from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32", num_hidden_layers=2)
GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)
V = CFG.vocab_size
SAMPLED = dict(do_sample=True, top_k=8)
COUNTERS = ("spec_steps", "spec_proposed_tokens", "spec_accepted_tokens",
            "spec_emitted_tokens", "draft_steps", "decode_steps")


def _carry(jm, tm):
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def llama():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=2))
    jm.eval()
    return _carry(jm, LlamaForCausalLM(CFG, device="cpu"))


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPT_TINY)
    jm.eval()
    tm = GPTForCausalLM(GPT_TINY, device="cpu")
    tm.eval()
    return _carry(jm, tm)


def _mask(*allowed):
    m = np.zeros(V, bool)
    m[list(allowed)] = True
    return m


def _drive(engine, reqs, stagger=True):
    """Submit (prompt, kwargs) pairs with a step between submissions,
    drain, return the per-request token lists."""
    handles = []
    for i, (p, kw) in enumerate(reqs):
        if stagger and i:
            engine.step()
        handles.append(engine.submit(p, **kw))
    engine.drain()
    return [list(h.tokens) for h in handles]


def _mixed_reqs(seed=0, max_new=10):
    """Two vocab-masked repetitive requests (verify fires) + two plain
    random ones (the decode fallback fires)."""
    rng = np.random.default_rng(seed)
    return [
        (np.full((9,), 7, np.int32),
         dict(max_new_tokens=max_new, logit_mask=_mask(7))),
        (rng.integers(0, V, (6,)).astype(np.int32),
         dict(max_new_tokens=max_new)),
        (np.asarray([11, 13] * 5, np.int32),
         dict(max_new_tokens=max_new, logit_mask=_mask(11, 13))),
        (rng.integers(0, V, (5,)).astype(np.int32),
         dict(max_new_tokens=max_new - 2)),
    ]


def _sampled_reqs():
    return [(p, dict(kw, temperature=0.9 + 0.2 * i, seed=40 + i))
            for i, (p, kw) in enumerate(_mixed_reqs(seed=2))]


def _draft_reqs():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, V, (n,)).astype(np.int32),
             dict(max_new_tokens=12)) for n in (6, 9, 11)]


def _tight_reqs():
    shared = np.full((8,), 7, np.int32)          # exactly one block
    return [
        (np.concatenate([shared, np.asarray([7, 7], np.int32)]),
         dict(max_new_tokens=14, logit_mask=_mask(7), seed=3)),
        (np.concatenate([shared, np.asarray([7], np.int32)]),
         dict(max_new_tokens=14, logit_mask=_mask(7), seed=9)),
    ]


class Hostile:
    """Proposes a token the request's mask forbids: every verify rejects
    at the first position."""

    def propose(self, ctx, k):
        return np.full(k, 9, np.int32)


def _hostile_reqs():
    return [(np.full((9,), 7, np.int32),
             dict(max_new_tokens=12, logit_mask=_mask(7)))]


# arm -> (model fixture, reqs, engine kwargs, draft ("self" = the model),
# k, stagger)
ARMS = {
    "llama-ngram-greedy": ("llama", _mixed_reqs, {}, "ngram", 4, True),
    "llama-ngram-sampled": ("llama", _sampled_reqs, SAMPLED, "ngram", 4,
                            True),
    "llama-self-draft": ("llama", _draft_reqs, {}, "self", 4, True),
    "llama-hostile": ("llama", _hostile_reqs, {}, "hostile", 4, False),
    "llama-hostile-unmasked": ("llama", _draft_reqs, {}, "hostile", 4,
                               True),
    "llama-tight-pool": ("llama", _tight_reqs, dict(SAMPLED, n_blocks=5),
                         "ngram", 4, True),
    "gpt-ngram-greedy": ("gpt", _mixed_reqs, {}, "ngram", 4, True),
    "gpt-self-draft": ("gpt", _draft_reqs, {}, "self", 4, True),
}


def _spec(cls, draft, model, k):
    d = {"ngram": "ngram", "self": model, "hostile": Hostile()}[draft]
    return cls(draft=d, k=k)


def _without_pool(kw):
    return {k: v for k, v in kw.items() if k != "n_blocks"}


@pytest.fixture(scope="module")
def jax_arms(request):
    """Per arm: the JAX plain engine's tokens (on an unconstrained pool),
    the JAX speculative engine's tokens and its counters."""
    out = {}
    for arm, (fix, reqs, kw, draft, k, stagger) in ARMS.items():
        jm, _ = request.getfixturevalue(fix)
        base = _drive(JaxEngine(jm, **GEO, **_without_pool(kw)), reqs(),
                      stagger)
        eng = JaxEngine(jm, speculative=_spec(JaxSpec, draft, jm, k),
                        **GEO, **kw)
        toks = _drive(eng, reqs(), stagger)
        out[arm] = (base, toks, {c: getattr(eng.metrics, c)
                                 for c in COUNTERS})
    return out


def _port_arm(request, arm):
    fix, reqs, kw, draft, k, stagger = ARMS[arm]
    _, tm = request.getfixturevalue(fix)
    eng = Engine(tm, speculative=_spec(SpecConfig, draft, tm, k), **GEO,
                 **kw)
    return eng, _drive(eng, reqs(), stagger)


# ---------------------------------------------------------------------------
# the verify body alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,n_write", [(13, 3), (60, 4)])
@pytest.mark.parametrize("sampled", [False, True])
def test_verify_body_matches_jax(llama, sampled, start, n_write):
    """One slot's verify over a random pool: the k+1 samples and the key
    words after each split equal JAX's; the pools within 1e-5 relative;
    the lines at and past ``start + n_write`` in the slot's own blocks
    untouched. (60, 4) runs past the last table entry: the clamped
    gather."""
    jm, tm = llama
    K1, bs, nb, S = 5, 8, 12, 2
    rng = np.random.default_rng(11 + start)
    L, kvh, hd = CFG.num_hidden_layers, CFG.num_key_value_heads, \
        CFG.hidden_size // CFG.num_attention_heads
    kc = rng.standard_normal((L, nb, bs, kvh, hd)).astype(np.float32)
    vc = rng.standard_normal((L, nb, bs, kvh, hd)).astype(np.float32)
    table = np.asarray([3, 7, 1, 9, 4, 10, 2, 11], np.int32)   # 64 lines
    ids = rng.integers(0, V, (1, K1)).astype(np.int32)
    keys = np.asarray([[12345, 678], [3141592653, 2718281828]], np.uint32)
    vmask = np.ones(V, np.float32)
    vmask[rng.integers(0, V, 200)] = 0.0
    slot, temp = 1, 0.8
    st = dict(do_sample=sampled, top_k=8 if sampled else 0,
              top_p=0.9 if sampled else None)
    w, hp, _ = jeng._make_arch(jm)
    jkc, jvc, jsamp, jchain = jeng._SPEC_VERIFY(
        w, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(keys),
        jnp.asarray(ids), np.int32(start), np.int32(slot),
        jnp.asarray(table), np.int32(n_write), np.float32(temp),
        jnp.asarray(vmask), block_size=bs, **hp, **st)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.inference_mode():
        samp, chain = teng._spec_verify_impl(
            G.arch_for(tm), tkc, tvc,
            torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(ids), start, slot, torch.from_numpy(table),
            n_write, torch.tensor(temp), torch.from_numpy(vmask),
            block_size=bs, **st)
    assert samp.tolist() == np.asarray(jsamp).tolist()
    assert chain.tolist() == np.asarray(jchain).astype(np.int64).tolist()
    for got, want, before in ((tkc, jkc, kc), (tvc, jvc, vc)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-5, rel
        for pos in range(start + n_write, min(start + K1, 64)):
            line = table[pos // bs], pos % bs
            np.testing.assert_array_equal(got.numpy()[:, line[0], line[1]],
                                          before[:, line[0], line[1]])
        written = [(table[p // bs], p % bs)
                   for p in range(start, start + n_write)]
        assert all(not np.array_equal(got.numpy()[:, b, o], before[:, b, o])
                   for b, o in written)


# ---------------------------------------------------------------------------
# token identity and counters with JAX, every arm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", list(ARMS))
def test_spec_engine_matches_jax(request, jax_arms, arm):
    base, jtoks, jcount = jax_arms[arm]
    eng, got = _port_arm(request, arm)
    assert jtoks == base                     # JAX's own guarantee
    assert got == base
    assert {c: getattr(eng.metrics, c) for c in COUNTERS} == jcount
    assert eng.verify_used and eng.metrics.spec_steps > 0
    assert eng.cache.check_refcounts()
    if arm == "llama-tight-pool":
        assert eng.metrics.prefix_hit_tokens > 0
        assert eng.metrics.preemptions > 0
    if arm.endswith("self-draft"):
        # a self-draft: acceptance near 1, target steps per token < 0.6
        m = eng.metrics
        assert m.acceptance_rate() > 0.5
        assert m.decode_steps / m.tokens_generated < 0.6
        assert eng.draft_decode_used and eng.draft_buckets_seen
        st = eng.stats()["speculative"]
        assert st["draft"] == "model" and st["verify_used"]
    if arm == "llama-hostile":
        # every verify emits exactly its corrective token: one prefill
        # token + (max_new - 1) one-token target steps
        m = eng.metrics
        assert m.spec_accepted_tokens == 0
        assert m.decode_steps == 12 - 1
        assert m.spec_emitted_tokens == m.spec_steps


# ---------------------------------------------------------------------------
# JAX's own checks, ported
# ---------------------------------------------------------------------------

def test_spec_validation(llama):
    _, tm = llama
    with pytest.raises(ValueError):
        SpecConfig(k=0)
    with pytest.raises(ValueError):
        SpecConfig(ngram_min=0)
    with pytest.raises(ValueError):
        SpecConfig(ngram_min=3, ngram_max=2)
    with pytest.raises(TypeError):
        Engine(tm, speculative=4, **GEO)
    with pytest.raises(ValueError):
        Engine(tm, speculative=SpecConfig(), kv_layout="slot", n_slots=2,
               max_len=64)
    assert SpecConfig(draft=Hostile()).draft_kind() == "custom"
    assert SpecConfig(draft=tm).draft_kind() == "model"


def test_model_draft_refusals_match_jax(llama, gpt):
    """A draft of another family, of another vocabulary, or (GPT) with a
    position table shorter than max_len: ValueError with JAX's
    message."""
    (jl, tl), (jg, tg) = llama, gpt
    paddle.seed(1)
    jv = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=1, vocab_size=512))
    jshort = jgpt.GPTForCausalLM(dataclasses.replace(
        jgpt.GPT_TINY, max_position_embeddings=32))
    tv = LlamaForCausalLM(dataclasses.replace(CFG, num_hidden_layers=1,
                                              vocab_size=512), device="cpu")
    tshort = GPTForCausalLM(dataclasses.replace(
        GPT_TINY, max_position_embeddings=32), device="cpu")
    for jt, jd, tt, td in ((jl, jg, tl, tg), (jl, jv, tl, tv),
                           (jg, jshort, tg, tshort)):
        with pytest.raises(ValueError) as want:
            JaxEngine(jt, speculative=JaxSpec(draft=jd), **GEO)
        with pytest.raises(ValueError) as got:
            Engine(tt, speculative=SpecConfig(draft=td), **GEO)
        assert str(got.value) == str(want.value)


def test_itl_records_per_emitted_token_intervals():
    # a 0.4 s step that emitted 4 tokens reads as 4 x 0.1 s intervals
    m = EngineMetrics()
    m.mark_decode(0.4, tokens=4)
    assert m.decode_steps == 1
    assert m.itl_hist.count == 4
    assert abs(m.itl_hist.sum - 0.4) < 1e-9
    assert m.itl_estimate() is not None and m.itl_estimate() < 0.2
    assert m.itl_p95() < 0.2
    # one token a step: as before
    m2 = EngineMetrics()
    m2.mark_decode(0.4)
    assert m2.decode_steps == 1
    assert m2.itl_estimate() > 0.2
    assert m2.acceptance_rate() is None
    assert m2.snapshot()["spec_acceptance_rate"] is None


def test_engine_itl_observation_count_matches_tokens(llama):
    """One histogram observation per token a decode or verify step
    emitted; the prefill's token is not a decode observation."""
    _, tm = llama
    eng = Engine(tm, speculative=SpecConfig(draft="ngram", k=4), **GEO)
    _drive(eng, [(np.full((9,), 7, np.int32),
                  dict(max_new_tokens=12, logit_mask=_mask(7)))],
           stagger=False)
    m = eng.metrics
    assert m.itl_hist.count == m.tokens_generated - m.prefills
    assert m.spec_emitted_tokens + (
        m.decode_steps - m.spec_steps) == m.tokens_generated - m.prefills


# ---------------------------------------------------------------------------
# planted faults: each must break the identity
# ---------------------------------------------------------------------------

def _accept_one_mismatch(samples, props):
    """Planted: the first draft token that differs from its chain sample
    is accepted too."""
    m = _true_accept_len(samples, props)
    return min(m + 1, len(props))


_true_accept_len = teng._accept_len


def _rewind_key_at_chain_end(self, h, p, e, samples, chain):
    """Planted: the key row left at chain[k] instead of chain[e-1]."""
    _true_rewind(self, h, p, e, samples, chain)
    with torch.inference_mode():
        self._keys[h.slot] = chain[-1]


def _rewind_no_cur(self, h, p, e, samples, chain):
    """Planted: cur left where the verify's writes ended (p + k + 1), not
    rewound to the accepted length."""
    _true_rewind(self, h, p, e, samples, chain)
    self.cache.cur_pos[h.slot] = p + len(samples)


_true_rewind = teng.Engine._rewind

# fault -> (attribute, its owner, the planted version, the arm it runs on)
FAULTS = {
    "accept-a-mismatch": ("_accept_len", teng, _accept_one_mismatch,
                          "llama-ngram-sampled"),
    "key-at-chain-end": ("_rewind", teng.Engine, _rewind_key_at_chain_end,
                         "llama-ngram-sampled"),
    "cur-not-rewound": ("_rewind", teng.Engine, _rewind_no_cur,
                        "llama-hostile-unmasked"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_identity(request, jax_arms, monkeypatch,
                                           fault):
    """Each fault changes the tokens of an arm where it acts: a wrong
    acceptance or key on the sampled n-gram arm (rejections on the {11,
    13} request, whose samples depend on the keys and the context); a cur
    left past the rejected lines on random prompts under the hostile
    proposer (every verify rejects, and the position a greedy token sees
    moves its logits; on the masked traffic two-token samples hide it).
    The unpatched engine gives JAX's plain tokens."""
    name, owner, planted, arm = FAULTS[fault]
    base = jax_arms[arm][0]
    assert _port_arm(request, arm)[1] == base
    monkeypatch.setattr(owner, name, planted)
    assert _port_arm(request, arm)[1] != base
