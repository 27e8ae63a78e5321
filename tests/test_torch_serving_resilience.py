"""The serving supervisor of the PyTorch port against the JAX package's.

The tiny fp32 Llama (2 layers, GQA 8/4) is built in the JAX package and
carried into the port through numpy. On ``tests/test_serving_resilience.py``'s
geometry, schedules and ``ChaosMonkey`` plans, the port's
``EngineSupervisor`` rebuilds and replays through decode-stall,
decode-raise, kv-corrupt (also on a shared prefix block) and a real
wedge, greedy and sampled, and every request's tokens equal the JAX
supervisor's and the uninterrupted engine's; its counters (``rebuilds``,
``replayed``, ``wedges``, ...) and its ledger's counts equal the JAX
supervisor's. A wedge inside the decode step leaves a zombie thread that
decodes on the condemned engine: its late tokens are dropped. The rest of
the JAX file's checks are ported (abandon, EDF, brownout, drain, the
plans, the retry hint), with ``tests/test_serving_spec.py``'s adopt across
speculative modes and rebuild with speculative counters. Three planted
faults (a replay that does not fast-forward the key chain, the probe off,
the zombie guard off) must each break an identity.
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import resilience as jres
from paddle_tpu import serving as jsrv
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.resilience import (SERVING_FAULTS, ChaosMonkey,
                                         corrupt_kv)
from paddle_tpu_torch.serving import (Engine, EngineDraining,
                                      EngineOverloaded, EngineSupervisor,
                                      PriorityScheduler, RequestCancelled,
                                      RequestShed, SpecConfig)
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(LLAMA_TINY, dtype="float32", num_hidden_layers=2)
V = CFG.vocab_size

GREEDY = dict(n_slots=2, max_len=64, min_prompt_bucket=4)
SAMPLED = dict(n_slots=2, max_len=64, min_prompt_bucket=4, do_sample=True,
               top_k=8)
COUNTERS = ("rebuilds", "replayed", "wedges", "step_errors",
            "kv_corruptions", "shed", "abandoned", "drains")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with its weights), one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=2))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    yield jm, tm.eval()
    torch.set_num_threads(before)


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (n,)).astype(np.int32) for n in lens]


def _staggered(server, prompts, gen):
    """The JAX test's schedule against an engine or a supervisor of
    either package: three requests at different decode positions when a
    mid-run fault fires, a fourth queued behind the 2 slots."""
    handles = [server.submit(prompts[0], **gen[0])]
    server.step()
    server.step()
    handles.append(server.submit(prompts[1], **gen[1]))
    server.step()
    handles.append(server.submit(prompts[2], **gen[2]))
    handles.append(server.submit(prompts[3], **gen[3]))
    while any(not h.finished for h in handles):
        server.step()
    return handles


def _tokens(handles):
    return [list(map(int, h.tokens)) for h in handles]


def _counters(sup):
    return {k: getattr(sup, k) for k in COUNTERS}


CRASH = (_prompts([5, 9, 5, 6], seed=1),
         [dict(max_new_tokens=6, temperature=0.8, seed=11),
          dict(max_new_tokens=6, temperature=1.2, seed=7),
          dict(max_new_tokens=5, temperature=0.6, seed=3),
          dict(max_new_tokens=4, temperature=1.0, seed=23)])
CORRUPT = (_prompts([5, 9, 5, 6], seed=3),
           [dict(max_new_tokens=6, temperature=0.8, seed=4),
            dict(max_new_tokens=6, temperature=1.1, seed=5),
            dict(max_new_tokens=5, temperature=0.7, seed=6),
            dict(max_new_tokens=4, temperature=1.0, seed=8)])


def _chaos_run(mod, model, fault, work, **kw):
    """(tokens, counters, ledger counts, the supervisor) of a supervisor
    of ``mod``'s package under the plan {4: fault}."""
    chaos = mod.ChaosMonkey(seed=0, at={4: fault}, stall_s=0.01)
    sup = mod.EngineSupervisor(model, chaos=chaos, **kw)
    toks = _tokens(_staggered(sup, *work))
    assert chaos.fired == [(4, fault)]
    return toks, _counters(sup), sup.ledger.counts(), sup


class _JaxMod:
    ChaosMonkey = jres.ChaosMonkey
    Engine = jsrv.Engine
    EngineSupervisor = jsrv.EngineSupervisor


class _PortMod:
    ChaosMonkey = ChaosMonkey
    Engine = Engine
    EngineSupervisor = EngineSupervisor


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX engine's uninterrupted tokens and the JAX supervisor's runs
    under each planned fault, computed once."""
    jm, _ = pair
    out = {"crash_base": _tokens(_staggered(jsrv.Engine(jm, **SAMPLED),
                                            *CRASH)),
           "corrupt_base": _tokens(_staggered(jsrv.Engine(jm, **SAMPLED),
                                              *CORRUPT))}
    for fault in ("decode-stall", "decode-raise"):
        out[fault] = _chaos_run(_JaxMod, jm, fault, CRASH, **SAMPLED)[:3]
    out["kv-corrupt"] = _chaos_run(_JaxMod, jm, "kv-corrupt", CORRUPT,
                                   kv_probe_interval=1, **SAMPLED)[:3]
    return out


# ---------------------------------------------------------------------------
# wedge/crash mid-decode -> rebuild -> token-identical replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["decode-stall", "decode-raise"])
def test_crash_mid_decode_replays_token_identical(pair, jax_runs, fault):
    """A stall or a raise at supervised step 4, three requests at
    different positions: the port's sampled tokens equal the JAX
    supervisor's and the uninterrupted run's; counters and ledger equal
    the JAX supervisor's."""
    _, tm = pair
    want = _tokens(_staggered(Engine(tm, **SAMPLED), *CRASH))
    assert want == jax_runs["crash_base"]
    toks, counters, ledger, sup = _chaos_run(_PortMod, tm, fault, CRASH,
                                             **SAMPLED)
    jtoks, jcounters, jledger = jax_runs[fault]
    assert toks == want == jtoks
    assert counters == jcounters and ledger == jledger
    assert sup.rebuilds == 1 and sup.replayed >= 2
    assert ledger["rebuild"] == 1 and ledger["anomaly"] == 1


def _wedge(mod, model, step_timeout_s, sleep_s):
    """JAX's real-wedge schedule: the first engine step blocks past the
    timeout on its worker thread, then steps the condemned engine. An
    uninterrupted engine serves the prompts first (JAX compiles its
    programs there, outside the timed steps)."""
    prompts = _prompts([5, 5], seed=2)
    mod.Engine(model, **GREEDY).generate_all(prompts, max_new_tokens=5)
    sup = mod.EngineSupervisor(model, step_timeout_s=step_timeout_s,
                               **GREEDY)
    hs = [sup.submit(p, max_new_tokens=5) for p in prompts]
    orig_step = sup.engine.step
    state = {"blocked": False}

    def wedged_step():
        if not state["blocked"]:
            state["blocked"] = True
            time.sleep(sleep_s)
        return orig_step()

    sup.engine.step = wedged_step
    while any(not h.finished for h in hs):
        sup.step()
    return hs, sup


def test_real_wedge_timeout_thread_and_zombie_guard(pair):
    """A step that blocks past ``step_timeout_s`` is abandoned on its
    worker thread and the engine rebuilt: the same tokens, counters and
    ledger as the JAX supervisor under the same wedge, and no late token
    once the zombie thread has returned."""
    jm, tm = pair
    jhs, jsup = _wedge(_JaxMod, jm, 0.3, 0.9)
    hs, sup = _wedge(_PortMod, tm, 0.3, 0.9)
    want = _tokens(jhs)
    assert _tokens(hs) == want
    assert sup.wedges == 1 and sup.rebuilds == 1
    assert _counters(sup) == _counters(jsup)
    assert sup.ledger.counts() == jsup.ledger.counts()
    time.sleep(1.0)                     # the zombie thread returns
    assert _tokens(hs) == want


def _decode_wedge(model, sleep_s=0.9):
    """A wedge INSIDE the second decode step (after the step's own
    condemnation check): the zombie thread then decodes on the condemned
    engine when it wakes. Returns the handles, the supervisor and the
    first engine."""
    sup = EngineSupervisor(model, step_timeout_s=0.3, **SAMPLED)
    first = sup.engine
    orig = first._decode_once
    calls = {"n": 0}

    def slow(active):
        calls["n"] += 1
        if calls["n"] == 2:
            time.sleep(sleep_s)
        return orig(active)

    first._decode_once = slow
    hs = _staggered(sup, *CRASH)
    time.sleep(sleep_s + 0.2)           # the zombie's decode returns
    return hs, sup, first


def test_wedge_inside_decode_drops_the_zombies_tokens(pair, jax_runs):
    """The zombie's decode step ran on the condemned engine and every
    token it would have emitted was dropped: the requests' tokens are
    the uninterrupted JAX run's."""
    _, tm = pair
    hs, sup, first = _decode_wedge(tm)
    assert sup.wedges == 1 and sup.rebuilds == 1
    assert first.dropped_emissions > 0
    assert _tokens(hs) == jax_runs["crash_base"]


def test_kv_corrupt_detected_and_healed(pair, jax_runs):
    """KV poisoning is caught by the probe before the next decode step
    reads it; the replay recomputes the KV from the requests' tokens."""
    _, tm = pair
    toks, counters, ledger, sup = _chaos_run(
        _PortMod, tm, "kv-corrupt", CORRUPT, kv_probe_interval=1, **SAMPLED)
    jtoks, jcounters, jledger = jax_runs["kv-corrupt"]
    assert toks == jtoks == jax_runs["corrupt_base"]
    assert sup.kv_corruptions == 1 and sup.rebuilds == 1
    assert counters == jcounters and ledger == jledger
    assert sup.kv_probes > 0


def test_supervisor_heals_corrupted_shared_block(pair):
    """kv-corrupt on a paged engine poisons a SHARED prefix block (JAX's
    ``test_serving_paged.py`` case); every sharer is healed, with the JAX
    supervisor's tokens and consistent refcounts."""
    jm, tm = pair
    rng = np.random.default_rng(6)
    sys_p = rng.integers(0, V, (8,)).astype(np.int32)
    reqs = [np.concatenate([sys_p, rng.integers(0, V, (k,)).astype(
        np.int32)]) for k in (3, 4)]
    kw = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8,
              do_sample=True, top_k=8)
    gen = [dict(max_new_tokens=6, temperature=0.8, seed=11),
           dict(max_new_tokens=6, temperature=1.2, seed=7)]

    def drive(server):
        hs = [server.submit(p, **g) for p, g in zip(reqs, gen)]
        while any(not h.finished for h in hs):
            server.step()
        return _tokens(hs)

    want = drive(Engine(tm, **kw))
    sups = [mod.EngineSupervisor(m, chaos=mod.ChaosMonkey(
        seed=0, at={2: "kv-corrupt"}), kv_probe_interval=1, **kw)
        for mod, m in ((_JaxMod, jm), (_PortMod, tm))]
    jtoks, toks = (drive(s) for s in sups)
    jsup, sup = sups
    assert toks == jtoks == want
    assert sup.kv_corruptions == 1 and sup.rebuilds == 1
    assert _counters(sup) == _counters(jsup)
    assert sup.engine.cache.check_refcounts()
    assert sup.engine.metrics.prefix_hit_tokens > 0    # re-shared


def test_corrupt_kv_picks_the_jax_block(pair):
    """On the same engine state (two requests sharing a full prefix
    block) the port's ``corrupt_kv`` poisons the block the JAX one
    poisons, and an engine with nothing live refuses."""
    jm, tm = pair
    with pytest.raises(ValueError):
        corrupt_kv(Engine(tm, **GREEDY))
    rng = np.random.default_rng(6)
    sys_p = rng.integers(0, V, (8,)).astype(np.int32)
    reqs = [np.concatenate([sys_p, rng.integers(0, V, (k,)).astype(
        np.int32)]) for k in (3, 4, 9)]
    kw = dict(n_slots=3, max_len=64, min_prompt_bucket=4, block_size=8)
    picks = []
    for eng, corrupt in ((jsrv.Engine(jm, **kw), jres.corrupt_kv),
                         (Engine(tm, **kw), corrupt_kv)):
        for p in reqs:
            eng.submit(p, max_new_tokens=4)
        picks.append([corrupt(eng, seed=s) for s in range(4)])
        assert eng.cache.shared_live_blocks() and all(
            b in eng.cache.shared_live_blocks() for b in picks[-1])
    assert picks[0] == picks[1]
    assert not torch.isfinite(eng.cache.kc[:, picks[1][0]]).any()


# ---------------------------------------------------------------------------
# client abandon, priority classes, brownout, drain
# ---------------------------------------------------------------------------

def test_client_abandon_frees_slot_neighbours_unaffected(pair):
    jm, tm = pair
    prompts = _prompts([5, 5, 5], seed=4)
    ref = jsrv.Engine(jm, **GREEDY).submit(prompts[1], max_new_tokens=5)
    ref.result()
    sup = EngineSupervisor(tm, n_slots=1, max_len=64, min_prompt_bucket=4)
    victim = sup.submit(prompts[0], max_new_tokens=8)
    survivor = sup.submit(prompts[1], max_new_tokens=5)
    queued = sup.submit(prompts[2], max_new_tokens=5)
    sup.step()
    assert victim.slot is not None and survivor.slot is None
    assert sup.cancel(victim) and not sup.cancel(victim)    # idempotent
    assert victim.finish_reason == "cancelled"
    with pytest.raises(RequestCancelled):
        victim.result()
    assert sup.cancel(queued)
    assert sup.engine.scheduler.queue_depth == 1            # survivor
    assert list(survivor.result()[5:]) == list(ref.tokens)
    assert sup.engine.metrics.requests_cancelled == 2
    assert sup.engine.cache.n_free == 1


def test_chaos_abandon_cancels_the_oldest_like_jax(pair):
    """The ``abandon`` fault cancels the lowest request id in flight; the
    others finish with the JAX supervisor's tokens and counters."""
    jm, tm = pair
    runs = []
    for mod, m in ((_JaxMod, jm), (_PortMod, tm)):
        chaos = mod.ChaosMonkey(seed=0, at={3: "abandon"})
        sup = mod.EngineSupervisor(m, chaos=chaos, **SAMPLED)
        hs = _staggered(sup, *CRASH)
        runs.append((_tokens(hs), [h.finish_reason for h in hs],
                     _counters(sup), sup.ledger.counts()))
    assert runs[0] == runs[1]
    assert runs[1][1][0] == "cancelled" and runs[1][2]["abandoned"] == 1


class _H:
    _n = 0

    def __init__(self, priority=0, deadline=None, tokens=4):
        self.priority = priority
        self.deadline = deadline
        self.n_prompt, self.max_new_tokens = tokens, 0
        self.request_id = _H._n
        _H._n += 1


def test_priority_scheduler_edf_within_class_fifo_behind():
    """Lower class first, EDF within a class, FIFO behind; the watermark
    blocks the urgent head; shedding takes the lowest class only -- the
    JAX scheduler's answers on the same queues."""
    got = {}
    for name, cls in (("jax", jsrv.PriorityScheduler),
                      ("port", PriorityScheduler)):
        s = cls(token_budget=100, max_queue=16)
        hs = [_H(priority=2, deadline=50.0), _H(priority=2, deadline=10.0),
              _H(priority=0), _H(priority=0, deadline=5.0), _H(priority=0)]
        for h in hs:
            s.enqueue(h)
        order = [hs.index(h) for h in s.pop_admissible(free_slots=5)]
        s2 = cls(token_budget=10, max_queue=8)
        small_low, big_urgent = _H(priority=1, tokens=3), _H(
            priority=0, deadline=1.0, tokens=8)
        s2.enqueue(small_low)
        s2.enqueue(big_urgent)
        first = s2.pop_admissible(free_slots=2) == [big_urgent]
        s2.release(big_urgent)
        second = s2.pop_admissible(2) == [small_low]
        s3 = cls(token_budget=100, max_queue=16)
        for p in (0, 2, 5, 5, 2):
            s3.enqueue(_H(priority=p))
        shed = sorted(h.priority for h in s3.shed_lowest(0))
        got[name] = (order, first, second, shed, s3.queue_depth,
                     s3.shed_lowest(protect_priority=2))
    assert got["port"] == got["jax"]
    assert got["port"] == ([3, 2, 4, 1, 0], True, True, [5, 5], 3, [])


def test_engine_priority_admission_order(pair):
    _, tm = pair
    prompts = _prompts([5, 5, 5], seed=5)
    eng = Engine(tm, n_slots=1, max_len=64, min_prompt_bucket=4)
    hog = eng.submit(prompts[0], max_new_tokens=2)
    low = eng.submit(prompts[1], max_new_tokens=2, priority=5)
    high = eng.submit(prompts[2], max_new_tokens=2, priority=0)
    order = []
    for h in (hog, low, high):
        h.on_token = lambda hh, t: (
            order.append(hh.request_id) if len(hh.tokens) == 1 else None)
    eng.drain()
    assert order == [high.request_id, low.request_id]


def test_brownout_sheds_low_priority_with_finite_retry_after(pair):
    """Rolling ITL p95 pushed over the SLO: queued low-priority work is
    shed with a finite hint, new low-priority submits are rejected, the
    protected class decodes the JAX engine's tokens; recovery exits
    brownout."""
    jm, tm = pair
    prompts = _prompts([5, 5, 5], seed=6)
    ref = jsrv.Engine(jm, **GREEDY).submit(prompts[0], max_new_tokens=6)
    ref.result()
    sup = EngineSupervisor(tm, n_slots=1, max_len=64, min_prompt_bucket=4,
                           itl_slo_ms=50.0)
    active_high = sup.submit(prompts[0], max_new_tokens=6, priority=0)
    queued_high = sup.submit(prompts[1], max_new_tokens=4, priority=0)
    queued_low = sup.submit(prompts[2], max_new_tokens=4, priority=5)
    for _ in range(8):
        sup.engine.metrics.mark_decode(0.5)
    sup.step()
    assert queued_low.finished and queued_low.finish_reason == "shed"
    assert np.isfinite(queued_low.retry_after_s)
    with pytest.raises(RequestShed) as si:
        queued_low.result()
    assert si.value.retry_after_s == queued_low.retry_after_s
    with pytest.raises(EngineOverloaded) as ei:
        sup.submit(prompts[2], max_new_tokens=4, priority=5)
    assert np.isfinite(ei.value.retry_after_s)
    assert sup.shed == 1 and sup.brownout_steps >= 1
    for _ in range(64):
        sup.engine.metrics.mark_decode(0.001)
    sup.step()
    assert not sup._brownout
    assert list(active_high.result()[5:]) == list(ref.tokens)
    queued_high.result()
    assert queued_high.finish_reason == "length"
    assert sup.ledger.counts().get("brownout-exit") == 1
    assert sup.engine.metrics.requests_shed == 1


def test_drain_finishes_inflight_admits_nothing_new(pair):
    _, tm = pair
    prompts = _prompts([5, 5], seed=7)
    sup = EngineSupervisor(tm, **GREEDY)
    h0 = sup.submit(prompts[0], max_new_tokens=4)
    h1 = sup.submit(prompts[1], max_new_tokens=6)
    report = sup.drain()
    assert report["drained"] and report["completed"] == 2
    assert h0.finished and h1.finished
    with pytest.raises(EngineDraining):
        sup.submit(prompts[0], max_new_tokens=2)
    assert sup.engine.metrics.requests_submitted == 2
    sup.reopen()
    sup.submit(prompts[0], max_new_tokens=2).result()
    assert sup.drains == 1 and sup.ledger.counts()["drain"] == 1


# ---------------------------------------------------------------------------
# chaos plans, the retry hint, counters, refusals
# ---------------------------------------------------------------------------

def test_serving_chaos_plans_deterministic():
    """The port's plans are the JAX package's for the same seeds, and
    ``take()`` consumes them as JAX's does."""
    for seed in (5, 6):
        a = ChaosMonkey(seed=seed, p=0.5, faults=SERVING_FAULTS,
                        horizon=32)
        j = jres.ChaosMonkey(seed=seed, p=0.5, faults=SERVING_FAULTS,
                             horizon=32)
        assert a.plan == j.plan and a.plan
        assert [a.take() for _ in range(32)] == [j.take()
                                                  for _ in range(32)]
        assert a.fired == j.fired and len(a.trace_ids) == len(a.fired)
    assert ChaosMonkey(seed=5, p=0.5, faults=SERVING_FAULTS).plan != \
        ChaosMonkey(seed=6, p=0.5, faults=SERVING_FAULTS).plan
    with pytest.raises(ValueError):
        ChaosMonkey(at={3: "decode-explode"})
    with pytest.raises(ValueError):
        ChaosMonkey(p=0.5, faults=("decode-stall", "bogus"))
    # the training fault 'corrupt' needs a CheckpointManager, as JAX's
    with pytest.raises(ValueError, match="needs ChaosMonkey"):
        ChaosMonkey(at={0: "corrupt"}, faults=("corrupt",)).wrap(
            lambda: 0)()


def test_retry_after_hint_cold_and_idle_engine(pair):
    _, tm = pair
    eng = Engine(tm, n_slots=1, max_len=64, min_prompt_bucket=4,
                 max_queue=1)
    assert eng._retry_after_hint() == eng.default_retry_after_s == 1.0
    p = _prompts([5], seed=8)[0]
    eng.submit(p, max_new_tokens=4)
    eng.submit(p, max_new_tokens=4)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(p, max_new_tokens=4)
    assert ei.value.retry_after_s == 1.0
    eng.drain()
    assert eng.metrics.itl_estimate() is not None
    assert eng._retry_after_hint() == 1.0
    eng2 = Engine(tm, n_slots=1, max_len=64, min_prompt_bucket=4,
                  default_retry_after_s=2.5)
    assert eng2._retry_after_hint() == 2.5


def test_global_counters_and_ledger_scopes(pair):
    """The summed supervisor counters see a live supervisor; serving
    ledgers are counted under their own scope; the engines' summed
    snapshot counts their requests."""
    from paddle_tpu_torch.resilience import ledger as led
    from paddle_tpu_torch.serving import metrics, resilience
    _, tm = pair
    sup = EngineSupervisor(tm, **GREEDY)
    sup.submit(_prompts([5], seed=9)[0], max_new_tokens=2).result()
    c = resilience.global_counters()
    assert c["supervisors"] >= 1
    assert set(COUNTERS) <= set(c)
    assert led.global_counters(scope="serving")["ledgers"] >= 1
    assert metrics.global_counters()["requests_completed"] >= 1
    assert sup.stats()["kv_probe"] == {"probes": 0, "seconds": 0.0}


def test_tp_supervisor_is_refused(pair):
    """``EngineSupervisor(tp=N)`` runs on the N ranks of a tp group
    (``tests/test_torch_serving_tp_resilience.py`` spawns them); in a
    one-process world it is refused with the error ``Engine(tp=N)``
    raises there."""
    _, tm = pair
    with pytest.raises(ValueError) as want:
        Engine(tm, tp=2, **GREEDY)
    with pytest.raises(ValueError) as got:
        EngineSupervisor(tm, tp=2, **GREEDY)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# speculative engines (tests/test_serving_spec.py:209, :235)
# ---------------------------------------------------------------------------

SPEC_GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)


def _mask(*allowed):
    m = np.zeros(V, bool)
    m[list(allowed)] = True
    return m


def _mixed_reqs(seed):
    rng = np.random.default_rng(seed)
    return [(np.full((9,), 7, np.int32),
             dict(max_new_tokens=10, logit_mask=_mask(7))),
            (rng.integers(0, V, (6,)).astype(np.int32),
             dict(max_new_tokens=10)),
            (np.asarray([11, 13] * 5, np.int32),
             dict(max_new_tokens=10, logit_mask=_mask(11, 13))),
            (rng.integers(0, V, (5,)).astype(np.int32),
             dict(max_new_tokens=8))]


def test_adopt_across_spec_modes(pair):
    """The fingerprint leaves out the speculative config: a speculative
    engine's in-flight handle adopts onto a plain engine and back, and
    finishes with the JAX engine's tokens."""
    jm, tm = pair
    prompt = np.full((9,), 7, np.int32)
    kw = dict(max_new_tokens=12, logit_mask=_mask(7), seed=5)
    base = list(jsrv.Engine(jm, do_sample=True, top_k=8, **SPEC_GEO)
                .generate_all([prompt], **kw)[0].tokens)
    for src, dst in ((SpecConfig(k=4), None), (None, SpecConfig(k=3))):
        a = Engine(tm, do_sample=True, top_k=8, speculative=src,
                   **SPEC_GEO)
        h = a.submit(prompt, **kw)
        for _ in range(3):
            a.step()
        assert 0 < len(h.tokens) < 12
        a._condemned = True
        b = Engine(tm, do_sample=True, top_k=8, speculative=dst,
                   **SPEC_GEO)
        assert b.model_fingerprint == a.model_fingerprint
        b.adopt(h)
        h.result()
        assert list(h.tokens) == base


def test_supervisor_rebuild_preserves_tokens_and_counters(pair):
    """A decode-raise under an n-gram speculative supervisor: the tokens
    and the speculative counters summed over both incarnations equal the
    JAX supervisor's, and the condemned engine's history survived."""
    jm, tm = pair
    kw = dict(SPEC_GEO, do_sample=True, top_k=8)
    runs = []
    for mod, m, spec in ((_JaxMod, jm, jsrv.SpecConfig),
                         (_PortMod, tm, SpecConfig)):
        sup = mod.EngineSupervisor(
            m, chaos=mod.ChaosMonkey(seed=0, at={5: "decode-raise"}),
            kv_probe_interval=1, speculative=spec(draft="ngram", k=4), **kw)
        hs = []
        for i, (p, skw) in enumerate(_mixed_reqs(seed=4)):
            if i:
                sup.step()
            hs.append(sup.submit(p, **skw))
        while any(not h.finished for h in hs):
            sup.step()
        runs.append((_tokens(hs), sup.spec_counters(), dict(sup.spec_totals),
                     _counters(sup)))
        assert sup.stats()["spec_counters_total"] == sup.spec_counters()
    assert runs[1] == runs[0]
    plain, hs = Engine(tm, **kw), []
    for i, (p, skw) in enumerate(_mixed_reqs(seed=4)):
        if i:
            plain.step()
        hs.append(plain.submit(p, **skw))
    plain.drain()
    assert runs[1][0] == _tokens(hs)
    assert runs[1][3]["rebuilds"] == 1 and runs[1][2]["spec_steps"] > 0


# ---------------------------------------------------------------------------
# planted faults: each must break an identity above
# ---------------------------------------------------------------------------

def _no_fast_forward(monkeypatch):
    orig = teng._admission_keys
    monkeypatch.setattr(teng, "_admission_keys",
                        lambda seed, skip, device: orig(seed, 0, device))


def _zombie_unguarded(monkeypatch):
    orig = teng.Engine._emit

    def emit(self, h, token):
        condemned, self._condemned = self._condemned, False
        try:
            orig(self, h, token)
        finally:
            self._condemned = condemned

    monkeypatch.setattr(teng.Engine, "_emit", emit)


@pytest.mark.parametrize("fault", ["no_fast_forward", "probe_off",
                                   "zombie_unguarded"])
def test_planted_faults_break_the_identity(pair, jax_runs, monkeypatch,
                                           fault):
    _, tm = pair
    if fault == "no_fast_forward":
        _no_fast_forward(monkeypatch)
        got = _chaos_run(_PortMod, tm, "decode-raise", CRASH, **SAMPLED)[0]
        want = jax_runs["crash_base"]
    elif fault == "probe_off":
        got = _chaos_run(_PortMod, tm, "kv-corrupt", CORRUPT,
                         kv_probe_interval=0, **SAMPLED)[0]
        want = jax_runs["corrupt_base"]
    else:
        _zombie_unguarded(monkeypatch)
        got = _tokens(_decode_wedge(tm)[0])
        want = jax_runs["crash_base"]
    assert got != want


# ---------------------------------------------------------------------------
# tools/torch_chaos_serve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--fault", "stall"],
                                  ["--spec", "--fault", "raise"]])
def test_chaos_serve_cli_smoke(capsys, argv):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_chaos_serve
    finally:
        sys.path.pop(0)
    rc = torch_chaos_serve.main(argv + ["--json", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"] and rec["token_identical"]
    assert rec["rebuilds"] == 1 and rec["fired"] == [
        [4, "decode-stall" if "stall" in argv else "decode-raise"]]


# ---------------------------------------------------------------------------
# soak (slow): seeded chaos over random arrivals
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_soak_chaos_sweep_random_arrivals(pair):
    _, tm = pair
    rng = np.random.default_rng(10)
    reqs = [(rng.integers(0, V, (int(n),)).astype(np.int32), int(m), int(s))
            for n, m, s in zip(rng.integers(4, 13, 16),
                               rng.integers(2, 8, 16),
                               rng.integers(0, 1 << 30, 16))]
    kw = dict(n_slots=4, max_len=64, min_prompt_bucket=4, do_sample=True,
              top_k=8)

    def run(server):
        handles = []
        for i, (p, m, s) in enumerate(reqs):
            handles.append(server.submit(p, max_new_tokens=m, seed=s,
                                         temperature=0.9))
            for _ in range(int(i % 3)):
                server.step()
        while any(not h.finished for h in handles):
            server.step()
        return handles

    want = _tokens(run(Engine(tm, **kw)))
    for seed in (1, 2, 3):
        chaos = ChaosMonkey(seed=seed, p=0.15, faults=SERVING_FAULTS,
                            stall_s=0.01, horizon=256)
        sup = EngineSupervisor(tm, chaos=chaos, kv_probe_interval=1,
                               step_timeout_s=5.0, **kw)
        got = run(sup)
        for i, h in enumerate(got):
            if h.finish_reason != "cancelled":
                assert list(h.tokens) == want[i], (seed, i, chaos.fired)
        assert sup.engine.cache.n_active == 0
