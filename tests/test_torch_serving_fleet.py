"""The replica fleet of the PyTorch port against the JAX package's.

The tiny fp32 Llama (2 layers, GQA 8/4) is built in the JAX package and
carried into the port through numpy. On ``tests/test_serving_fleet.py``'s
geometry, schedules and ``ChaosMonkey`` plans, the port's ``ReplicaFleet``
migrates the requests of a killed, stalled or KV-corrupted replica through
``adopt`` and every request finishes with the JAX fleet's tokens (the
single-engine run's), on the replica the JAX fleet finished it on, with
the JAX fleet's migrations and ledger counts (in both fleets' runs the
routing load goes without its wall-clock term, the rolling ITL p95, so
that the replica choice rests on host state alone: ``_pin_load``).
Route-flap places requests by the same seeded permutation. The paged
cache's routing probes answer as JAX's. The rest of the JAX file's
checks are ported: trace ids and replica tags across a migration, prefix
routing, browned-out rerouting and fleet-wide shedding, backoff, kill /
drain / re-register, the adopt guard (a GPT handle offered to a Llama
replica among its cases), validation and ``tools/torch_chaos_serve.py
--fleet``. Two planted faults (a migration that does not fast-forward the
key chain, a prefix-blind router) must each break an identity.
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
from paddle_tpu_torch.resilience import FLEET_FAULTS, ChaosMonkey
from paddle_tpu_torch.serving import (AdoptMismatch, Engine, EngineDraining,
                                      EngineOverloaded, ReplicaFleet,
                                      RequestShed)
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(LLAMA_TINY, dtype="float32", num_hidden_layers=2)
V = CFG.vocab_size

GREEDY = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)
SAMPLED = dict(do_sample=True, top_k=8, **GREEDY)
_GEN = [dict(max_new_tokens=6, temperature=0.8, seed=11),
        dict(max_new_tokens=6, temperature=1.2, seed=7),
        dict(max_new_tokens=5, temperature=0.6, seed=3),
        dict(max_new_tokens=4, temperature=1.0, seed=23)]


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


def _prompts(lens, seed, shared_prefix=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, V, (shared_prefix,)).astype(np.int32)
    out = []
    for n in lens:
        tail = rng.integers(0, V, (int(n),)).astype(np.int32)
        out.append(np.concatenate([prefix, tail]) if shared_prefix
                   else tail)
    return out


def _staggered(server, prompts, gen):
    """The JAX test's schedule: three requests at different decode
    positions when a mid-run fault fires."""
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


def _pin_load(monkeypatch, fleet_mod):
    """The routing load without its wall-clock term (the rolling ITL p95):
    both packages then route on the same host state alone. Everything
    else in the router is as shipped."""
    orig = fleet_mod.ReplicaFleet._load

    def load(engine):
        p95 = engine.metrics.itl_p95
        engine.metrics.itl_p95 = lambda: None
        try:
            return orig(engine)
        finally:
            engine.metrics.itl_p95 = p95

    monkeypatch.setattr(fleet_mod.ReplicaFleet, "_load", staticmethod(load))


def _fleet_run(mods, model, fault, prompts, **kw):
    """(tokens, replica per request, finish reasons, fleet counters,
    ledger counts, the fleet) under the plan {4: fault}."""
    chaos_cls, fleet_cls = mods
    chaos = chaos_cls(seed=0, at={4: fault}, stall_s=0.01)
    fleet = fleet_cls(model, 3, chaos=chaos, kv_probe_interval=1, **kw)
    hs = _staggered(fleet, prompts, _GEN)
    assert chaos.fired == [(4, fault)]
    return (_tokens(hs), [h.replica_id for h in hs],
            [h.finish_reason for h in hs], fleet.counters(),
            fleet.ledger.counts(), fleet)


JAX = (jres.ChaosMonkey, jsrv.ReplicaFleet)
PORT = (ChaosMonkey, ReplicaFleet)
FAULT_PROMPTS = _prompts([3, 4, 5, 6], seed=1, shared_prefix=8)
FLAP_PROMPTS = _prompts([3, 4, 5, 6], seed=6, shared_prefix=8)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX single engine's tokens and the JAX fleet's runs per fault
    (routing load pinned as in the port's runs), computed once."""
    jm, _ = pair
    mp = pytest.MonkeyPatch()
    _pin_load(mp, jsrv.fleet)
    try:
        out = {"base": _tokens(_staggered(jsrv.Engine(jm, **SAMPLED),
                                          FAULT_PROMPTS, _GEN)),
               "flap_base": _tokens(_staggered(jsrv.Engine(jm, **SAMPLED),
                                               FLAP_PROMPTS, _GEN))}
        for fault in ("replica-kill", "decode-stall", "kv-corrupt"):
            out[fault] = _fleet_run(JAX, jm, fault, FAULT_PROMPTS,
                                    **SAMPLED)[:5]
        fleet = jsrv.ReplicaFleet(jm, 3, chaos=jres.ChaosMonkey(
            seed=1, at={0: "route-flap"}), **SAMPLED)
        hs = _staggered(fleet, FLAP_PROMPTS, _GEN)
        out["route-flap"] = (_tokens(hs), [h.replica_id for h in hs])
    finally:
        mp.undo()
    return out


# ---------------------------------------------------------------------------
# one replica faulted mid-decode -> migration, zero lost, token-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["replica-kill", "decode-stall",
                                   "kv-corrupt"])
def test_replica_fault_migrates_token_identical(pair, jax_runs, monkeypatch,
                                                fault):
    _, tm = pair
    _pin_load(monkeypatch, tfleet)
    toks, reps, reasons, counters, ledger, fleet = _fleet_run(
        PORT, tm, fault, FAULT_PROMPTS, **SAMPLED)
    jtoks, jreps, jreasons, jcounters, jledger = jax_runs[fault]
    assert toks == jtoks == jax_runs["base"]
    assert reps == jreps                   # the same replica per request
    assert reasons == jreasons == ["length"] * 4          # zero lost
    assert counters == jcounters and ledger == jledger
    assert fleet.migrations >= 1 and fleet.re_registers == 1
    assert all(s == "healthy" for s in fleet.replica_states().values())
    assert ledger["migrate"] == fleet.migrations
    if fault == "replica-kill":
        assert fleet.replica_kills == 1
    assert all(r.engine.cache.check_refcounts()
               for r in fleet.replicas.values())


def test_migration_keeps_trace_id_and_replica_tag(pair):
    _, tm = pair
    prompts = _prompts([3, 4, 5, 6], seed=2, shared_prefix=8)
    fleet = ReplicaFleet(tm, 3, chaos=ChaosMonkey(
        seed=0, at={4: "replica-kill"}), **GREEDY)
    handles = [fleet.submit(prompts[0], **_GEN[0])]
    fleet.step()
    fleet.step()
    handles.append(fleet.submit(prompts[1], **_GEN[1]))
    origins = {h.request_id: h.trace_id for h in handles}
    for _ in range(3):
        fleet.step()
    assert fleet.replica_kills == 1 and fleet.migrations >= 1
    migrated = [r for r in fleet.ledger.to_list() if r["event"] == "migrate"]
    assert migrated
    for rec in migrated:
        h = next(x for x in handles if x.request_id == rec["request_id"])
        assert h.trace_id == rec["trace_id"] == origins[h.request_id]
        assert rec["target"] == h.replica_id != rec["source"]
    while any(not h.finished for h in handles):
        fleet.step()
    assert all(h.finish_reason == "length" for h in handles)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _prefix_routes(fleet_cls, model):
    fleet = fleet_cls(model, 3, **GREEDY)
    shared = _prompts([3], seed=3, shared_prefix=8)[0]
    h0 = fleet.submit(shared, max_new_tokens=2)
    while not h0.finished:
        fleet.step()
    h1 = fleet.submit(np.concatenate([shared[:8], _prompts([4], seed=4)[0]]),
                      max_new_tokens=2)
    h2 = fleet.submit(_prompts([5], seed=5)[0], max_new_tokens=2)
    while not (h1.finished and h2.finished):
        fleet.step()
    route = [r for r in fleet.ledger.to_list() if r["event"] == "route"]
    return ([h.replica_id for h in (h0, h1, h2)], fleet.prefix_routed,
            [r["prefix_tokens"] for r in route], fleet)


def test_routing_prefers_prefix_holding_replica(pair):
    """A request sharing a full-block prefix routes to THE replica whose
    radix holds it; a prefix-less one balances away from it; the JAX
    fleet routes the same; the probe is read-only."""
    jm, tm = pair
    reps, n_prefix, prefix_tokens, fleet = _prefix_routes(ReplicaFleet, tm)
    assert reps[1] == reps[0] != reps[2]
    assert n_prefix == 1 and prefix_tokens == [0, 8, 0]
    assert all(r.engine.cache.check_refcounts()
               for r in fleet.replicas.values())
    assert _prefix_routes(jsrv.ReplicaFleet, jm)[:3] == (reps, n_prefix,
                                                         prefix_tokens)


def test_route_flap_does_not_change_tokens(pair, jax_runs):
    """route-flap places by the fleet's seeded permutation: the JAX
    fleet's replicas, and the single engine's tokens."""
    _, tm = pair
    fleet = ReplicaFleet(tm, 3, chaos=ChaosMonkey(seed=1,
                                                  at={0: "route-flap"}),
                         **SAMPLED)
    hs = _staggered(fleet, FLAP_PROMPTS, _GEN)
    assert fleet.route_flaps == 1
    assert _tokens(hs) == jax_runs["flap_base"] == jax_runs["route-flap"][0]
    assert [h.replica_id for h in hs] == jax_runs["route-flap"][1]


def test_kv_routing_probes_match_jax():
    """The paged cache's read-only probes (``RadixIndex.match_len``,
    ``owner``, ``shared_tokens``, ``live_blocks``, ``shared_live_blocks``)
    and ``RadixIndex.clear`` answer as the JAX cache's on the same
    admissions; ``match_len`` touches no LRU stamp and no refcount."""
    from paddle_tpu.serving import kv_cache as jkv
    from paddle_tpu_torch.serving import kv_cache as tkv
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, V, 20).astype(np.int32)
    seqs = [np.concatenate([sys_p, rng.integers(0, V, n).astype(np.int32)])
            for n in (5, 9, 3)]
    probe = np.concatenate([sys_p[:17], rng.integers(0, V, 6)])
    out = []
    for kv in (jkv, tkv):
        c = kv.PagedKVCache(1, 3, 64, 1, 4, np.float32 if kv is jkv
                            else torch.float32, block_size=8)
        for i, ids in enumerate(seqs):
            slot = c.alloc(100 + i)
            c.admit(slot, ids, len(ids) + 1)
            c.commit_prefix(slot, ids)
        touch = dict(c.radix._touch)
        refs = c.pool.refcount.copy()
        got = (c.radix.match_len(probe), c.radix.match_len(sys_p[:7]),
               [c.owner(s) for s in range(3)],
               [c.shared_tokens(s) for s in range(3)], c.live_blocks(),
               c.shared_live_blocks())
        assert c.radix._touch == touch
        assert np.array_equal(c.pool.refcount, refs)
        c.free(1)
        c.radix.clear(c.pool)
        out.append(got + (c.radix.n_nodes, c.pool.n_free,
                          c.check_refcounts()))
    assert out[1] == out[0]
    assert out[1][0] == 16 and out[1][1] == 0 and out[1][-1]


# ---------------------------------------------------------------------------
# brownout, backoff, kill / drain / re-register
# ---------------------------------------------------------------------------

def test_one_browned_replica_reroutes_all_browned_sheds_fleet_wide(pair):
    _, tm = pair
    prompts = _prompts([5, 5, 5, 5], seed=7)
    fleet = ReplicaFleet(tm, 2, n_slots=1, max_len=64, min_prompt_bucket=4,
                         itl_slo_ms=50.0)
    reps = list(fleet.replicas.values())
    hogs = [fleet.submit(prompts[i], max_new_tokens=8, priority=0)
            for i in range(2)]
    lows = [fleet.submit(prompts[2 + i], max_new_tokens=4, priority=5)
            for i in range(2)]
    assert {h.replica_id for h in hogs} == {"r0", "r1"}
    for _ in range(8):
        reps[0].engine.metrics.mark_decode(0.5)
    fleet.step()
    assert reps[0].sup._brownout and not reps[1].sup._brownout
    assert fleet.replica_states()["r0"] == "degraded"
    h = fleet.submit(prompts[0], max_new_tokens=2, priority=5)
    assert h.replica_id == "r1" and fleet.fleet_sheds == 0
    fleet.cancel(h)
    for _ in range(8):
        reps[1].engine.metrics.mark_decode(0.5)
    fleet.step()
    assert all(r.sup._brownout for r in reps)
    with pytest.raises(EngineOverloaded) as ei:
        fleet.submit(prompts[0], max_new_tokens=2, priority=5)
    assert ei.value.replica is None and np.isfinite(ei.value.retry_after_s)
    shed = [h for h in lows if h.finish_reason == "shed"]
    assert shed
    with pytest.raises(RequestShed) as si:
        shed[0].result()
    assert si.value.replica == shed[0].replica_id is not None
    hp = fleet.submit(prompts[1], max_new_tokens=2, priority=0)
    assert hp.replica_id is not None
    for r in reps:
        for _ in range(64):
            r.engine.metrics.mark_decode(0.001)
    fleet.step()
    assert all(s == "healthy" for s in fleet.replica_states().values())
    fleet.drain()
    assert all(h.finished for h in hogs + [hp])


def test_backoff_honors_retry_after(pair):
    _, tm = pair
    p = _prompts([5], seed=8)[0]
    fleet = ReplicaFleet(tm, 2, n_slots=1, max_len=64, min_prompt_bucket=4,
                         max_queue=1, seed=3, default_retry_after_s=0.05)
    h0 = fleet.submit(p, max_new_tokens=6)
    h1 = fleet.submit(p, max_new_tokens=2)
    assert h1.replica_id != h0.replica_id
    fleet.submit(p, max_new_tokens=2)
    fleet.submit(p, max_new_tokens=2)
    assert fleet.backoffs == 0
    with pytest.raises(EngineOverloaded) as ei:
        fleet.submit(p, max_new_tokens=2)
    assert ei.value.replica is None
    assert fleet.backoffs >= 1 and fleet.retries >= 1
    now = time.monotonic()
    for until in fleet._backoff_until.values():
        assert now - 0.05 < until <= now + 0.05 + 1e-3
    rec = [r for r in fleet.ledger.to_list() if r["event"] == "backoff"]
    assert rec and rec[0]["retry_after_s"] is not None
    time.sleep(0.06)
    fleet.drain()
    fleet.reopen()
    h4 = fleet.submit(p, max_new_tokens=2)
    assert h4.replica_id is not None
    h4.result()


def test_kill_drain_reregister_and_fleet_drain(pair):
    _, tm = pair
    prompts = _prompts([5, 5], seed=9)
    fleet = ReplicaFleet(tm, 2, cooldown_steps=3, **GREEDY)
    h0 = fleet.submit(prompts[0], max_new_tokens=6)
    victim = h0.replica_id
    assert fleet.kill_replica(victim) == 1 and h0.replica_id != victim
    assert fleet.replica_states()[victim] == "draining"
    h1 = fleet.submit(prompts[1], max_new_tokens=2)
    assert h1.replica_id != victim
    for _ in range(3):
        assert fleet.replica_states()[victim] == "draining"
        fleet.step()
    assert fleet.replica_states()[victim] == "healthy"
    assert fleet.re_registers == 1
    report = fleet.drain()
    assert report["drained"] and h0.finish_reason == "length"
    with pytest.raises(EngineDraining):
        fleet.submit(prompts[0], max_new_tokens=2)
    fleet.reopen()
    fleet.submit(prompts[0], max_new_tokens=2).result()


# ---------------------------------------------------------------------------
# the adopt guard, validation, counters
# ---------------------------------------------------------------------------

def test_adopt_guard_rejects_mismatched_model(pair):
    """adopt() refuses a handle from another model (a shallower Llama, a
    GPT) or sampling mode; the same model and mode adopts and finishes
    with the JAX engine's tokens."""
    jm, tm = pair
    other = LlamaForCausalLM(dataclasses.replace(CFG, num_hidden_layers=1),
                             device="cpu").eval()
    p = _prompts([5], seed=10)[0]
    a = Engine(tm, **GREEDY)
    h = a.submit(p, max_new_tokens=6)
    a.step()
    a._condemned = True
    with pytest.raises(AdoptMismatch, match="fingerprint"):
        Engine(other, **GREEDY).adopt(h)
    with pytest.raises(AdoptMismatch):
        Engine(tm, **SAMPLED).adopt(h)
    gpt = GPTForCausalLM(GPT_TINY, device="cpu").eval()
    g = Engine(gpt, **GREEDY)
    gh = g.submit(p, max_new_tokens=4)
    with pytest.raises(AdoptMismatch):
        Engine(tm, **GREEDY).adopt(gh)
    Engine(tm, **GREEDY).adopt(h)
    base = jsrv.Engine(jm, **GREEDY).generate_all(
        [p], max_new_tokens=6, seed=h.seed)[0]
    assert list(h.result()[len(p):]) == list(base.tokens)


def test_fleet_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaFleet(tm, 0)
    with pytest.raises(ValueError, match="tp_degrees"):
        ReplicaFleet(tm, 2, tp_degrees=[1])
    with pytest.raises(NotImplementedError, match="serving robustness"):
        ReplicaFleet(tm, 2, tp_degrees=[2, 1])
    with pytest.raises(ValueError):
        ChaosMonkey(at={1: "replica-explode"})
    assert set(FLEET_FAULTS) >= {"replica-kill", "route-flap"}
    assert FLEET_FAULTS == jres.FLEET_FAULTS


def test_fleet_counters_and_stats(pair):
    _, tm = pair
    fleet = ReplicaFleet(tm, 2, chaos=ChaosMonkey(seed=0,
                                                  at={2: "replica-kill"}),
                         **GREEDY)
    fleet.submit(_prompts([5], seed=12)[0], max_new_tokens=6).result()
    c = tfleet.global_counters()
    assert c["fleets"] >= 1 and c["replica_kills"] >= 1
    st = fleet.stats()
    assert set(st["per_replica"]) == {"r0", "r1"}
    assert st["states"] == fleet.replica_states()
    assert all(v["tp"] == 1 for v in st["per_replica"].values())


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["no_fast_forward", "prefix_blind"])
def test_planted_faults_break_the_identity(pair, jax_runs, monkeypatch,
                                           fault):
    jm, tm = pair
    if fault == "no_fast_forward":
        orig = teng._admission_keys
        monkeypatch.setattr(teng, "_admission_keys",
                            lambda seed, skip, dev: orig(seed, 0, dev))
        _pin_load(monkeypatch, tfleet)
        got = _fleet_run(PORT, tm, "replica-kill", FAULT_PROMPTS,
                         **SAMPLED)[0]
        assert got != jax_runs["base"]
    else:
        monkeypatch.setattr(tfleet.ReplicaFleet, "_prefix_len",
                            staticmethod(lambda engine, ids: 0))
        reps = _prefix_routes(ReplicaFleet, tm)[0]
        assert reps != _prefix_routes(jsrv.ReplicaFleet, jm)[0]


# ---------------------------------------------------------------------------
# tools/torch_chaos_serve.py --fleet
# ---------------------------------------------------------------------------

def test_chaos_serve_fleet_cli_smoke(capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_chaos_serve
    finally:
        sys.path.pop(0)
    rc = torch_chaos_serve.main(["--fleet", "3", "--fault", "kill", "--json",
                                 "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"] and rec["token_identical"]
    assert rec["zero_lost"]
    for arm in ("greedy", "sampled"):
        a = rec["arms"][arm]
        assert a["replica_kills"] == 1 and a["migrations"] >= 1
        assert a["fired"] == [[4, "replica-kill"]]


# ---------------------------------------------------------------------------
# slow: seeded chaos soak
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_soak_fleet_chaos_sweep(pair):
    _, tm = pair
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, V, (int(n),)).astype(np.int32), int(m), int(s))
            for n, m, s in zip(rng.integers(4, 13, 16),
                               rng.integers(2, 8, 16),
                               rng.integers(0, 1 << 30, 16))]

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

    want = _tokens(run(Engine(tm, **SAMPLED)))
    for seed in (1, 2, 3):
        chaos = ChaosMonkey(seed=seed, p=0.12, faults=FLEET_FAULTS,
                            stall_s=0.01, horizon=256)
        fleet = ReplicaFleet(tm, 3, chaos=chaos, kv_probe_interval=1,
                             seed=seed, **SAMPLED)
        got = run(fleet)
        assert _tokens(got) == want, (seed, chaos.fired)
        assert fleet.n_pending == 0
        assert all(r.engine.cache.check_refcounts()
                   for r in fleet.replicas.values())
