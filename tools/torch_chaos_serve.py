#!/usr/bin/env python
"""torch_chaos_serve -- drive the PyTorch port's serving EngineSupervisor
(or a whole ReplicaFleet) through an injected fault and emit a JSON
verdict (the port's counterpart of tools/chaos_serve.py; imports no JAX).

A tiny llama serves a staggered, SAMPLED workload (per-request seeds, so
the verdict also proves the PRNG-chain resume) twice: once uninterrupted
on a plain Engine (the baseline), once under
``serving.resilience.EngineSupervisor`` with a ChaosMonkey firing the
chosen serving fault at the chosen supervised step. The verdict asserts
every surviving request's full output is token-identical to the
uninterrupted run.

    python tools/torch_chaos_serve.py --fault stall --json
    python tools/torch_chaos_serve.py --fault corrupt --step 5
    python tools/torch_chaos_serve.py --fault abandon --device cpu

The model runs on the card unless ``--device cpu`` is given.

Faults: stall (wedged decode) | raise (decode error) | corrupt (KV slot
poisoned; probe must detect before decode consumes it) | abandon (client
disconnect mid-stream) | none. Exit code 0 iff the run recovered with
token-identical survivors.

``--spec`` runs the verdict against a SPECULATIVE engine
(``Engine(speculative=SpecConfig(draft="ngram", k=4))``) wrapped in the
supervisor, with part of the workload vocab-masked repetitive so the
verify program provably runs before the fault fires. The baseline is
the plain NON-speculative engine -- the verdict asserts the recovered
speculative run is token-identical to it (the speculative token-
identity contract composed with fault recovery) and that the
acceptance counters survive the rebuild (``EngineSupervisor``
accumulates condemned incarnations' spec counters):

    python tools/torch_chaos_serve.py --spec --fault raise

``--fleet N`` runs the fleet verdict instead: N supervised replicas
behind a ``ReplicaFleet`` serve the shared-prefix workload GREEDY and
SAMPLED while the fault (kill = replica-kill | stall | raise | corrupt |
flap = route-flap | none) fires mid-decode into one replica. The verdict
asserts ``zero_lost`` (every request finishes) and ``token_identical``
(every output equals the uninterrupted SINGLE-ENGINE baseline -- the
in-flight requests of the faulted replica complete via cross-replica
``adopt()`` migration) in BOTH arms:

    python tools/torch_chaos_serve.py --fleet 3 --fault kill

``--tp N`` runs the single-engine verdict under tensor parallelism: N
ranks (``distributed.spawn``) each run ``EngineSupervisor(model, tp=N)``
in lockstep against a tp-1 baseline on the rank's device; ``--rank R``
confines the fault to rank R (``ChaosMonkey(ranks=)``: a raise, a stall
inside R's decode step past ``--step-timeout-s``, a corruption of R's KV
shard). The verdict adds that every rank emitted the same tokens, rebuilt
as often and kept the same ledger. On one card the ranks share it over
gloo (``--backend gloo``, the default); ``--backend nccl`` puts one rank
on each of N cards:

    python tools/torch_chaos_serve.py --tp 2 --fault raise --rank 1
    python tools/torch_chaos_serve.py --tp 4 --fault stall --rank 3 \
        --backend nccl
"""
import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_FAULT_MAP = {"stall": "decode-stall", "raise": "decode-raise",
              "corrupt": "kv-corrupt", "abandon": "abandon"}
_FLEET_FAULT_MAP = {"kill": "replica-kill", "stall": "decode-stall",
                    "raise": "decode-raise", "corrupt": "kv-corrupt",
                    "flap": "route-flap"}


def _workload(seed):
    """Deterministic staggered workload: (prompt, max_new, temp, seed)
    per request, plus the submission schedule (request idx -> steps to
    pump before the next arrival). >=3 requests in flight at different
    positions when a mid-run fault fires. The first two requests share
    an 8-token system prefix -- one full paged block -- so the kv-corrupt
    fault has a live SHARED prefix block to poison (the nastiest case:
    every sharer reads it, and replay must heal them all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sys_prefix = rng.integers(0, 1000, (8,)).astype(np.int32)

    def prompt(n, shared):
        tail = rng.integers(0, 1000, (int(n),)).astype(np.int32)
        return np.concatenate([sys_prefix, tail]) if shared else tail

    reqs = [(prompt(n, sh), int(m), float(t), int(s))
            for n, m, t, s, sh in ((3, 8, 0.8, 11, True),
                                   (4, 8, 1.2, 7, True),
                                   (5, 7, 0.6, 3, False),
                                   (6, 6, 1.0, 23, False))]
    schedule = (2, 1, 1, 0)     # decode steps pumped after each submit
    return reqs, schedule


def _run(server, reqs, schedule):
    """Submit the workload on the given engine/supervisor, pump to
    completion, return the handles (order = submission order)."""
    handles = []
    for (ids, m, t, s), pump in zip(reqs, schedule):
        handles.append(server.submit(ids, max_new_tokens=m, temperature=t,
                                     seed=s))
        for _ in range(pump):
            server.step()
    while any(not h.finished for h in handles):
        server.step()
    return handles


def _model(device):
    """The tiny fp32 Llama (2 layers) from seed 0 on ``device``."""
    import dataclasses

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              num_hidden_layers=2)
    pt.seed(0)
    return LlamaForCausalLM(cfg, device=device).eval()


def _verdict(fault, step, seed, stall_s, device):
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import Engine, EngineSupervisor

    model = _model(device)
    kw = dict(n_slots=2, max_len=64, min_prompt_bucket=4, do_sample=True,
              top_k=8, block_size=8)     # 8-token blocks: the shared
    reqs, schedule = _workload(seed)     # prefix aliases one full block

    baseline = _run(Engine(model, **kw), reqs, schedule)
    base_tokens = [list(h.tokens) for h in baseline]

    chaos = ChaosMonkey(seed=seed,
                        at=({int(step): _FAULT_MAP[fault]}
                            if fault != "none" else {}),
                        stall_s=stall_s)
    sup = EngineSupervisor(model, chaos=chaos, step_timeout_s=None,
                           kv_probe_interval=1, **kw)
    handles = _run(sup, reqs, schedule)

    abandoned = [h for h in handles if h.finish_reason == "cancelled"]
    survivors = [(i, h) for i, h in enumerate(handles)
                 if h.finish_reason not in ("cancelled",)]
    mismatches = [i for i, h in survivors if list(h.tokens) != base_tokens[i]]
    fired = list(chaos.fired)
    expected_counter = {"stall": sup.wedges + sup.step_errors,
                        "raise": sup.step_errors,
                        "corrupt": sup.kv_corruptions,
                        "abandon": sup.abandoned}.get(fault, 0)
    detected = fault == "none" or (bool(fired) and expected_counter > 0)
    recovered = (fault in ("none", "abandon")
                 or sup.rebuilds > 0) and not mismatches
    # the engine must still be healthy after the fault: everything done
    idle = (sup.engine.cache.n_active == 0
            and sup.engine.scheduler.queue_depth == 0)
    # paged-pool hygiene: block/radix refcounts must balance after the
    # fault + replay, and the corrupt fault must have exercised prefix
    # sharing (the poisoned block had sharers to heal)
    refcounts_ok = sup.engine.cache.check_refcounts()
    shared_tokens = sup.engine.metrics.prefix_hit_tokens
    shared_ok = fault != "corrupt" or shared_tokens > 0
    ok = bool(detected and recovered and idle and refcounts_ok
              and shared_ok
              and (fault != "abandon" or len(abandoned) == 1))
    return {
        "fault": fault, "injected_step": step, "seed": seed,
        "requests": len(reqs), "fired": fired,
        "trace_id": chaos.last_trace_id,
        "request_trace_ids": [h.trace_id for h in handles],
        "rebuilds": sup.rebuilds, "replayed": sup.replayed,
        "wedges": sup.wedges, "step_errors": sup.step_errors,
        "kv_corruptions": sup.kv_corruptions, "abandoned": sup.abandoned,
        "survivors": len(survivors), "mismatched_requests": mismatches,
        "token_identical": not mismatches,
        "refcounts_consistent": refcounts_ok,
        "prefix_hit_tokens": int(shared_tokens),
        "ledger": sup.ledger.counts(),
        "ok": ok,
    }


def _spec_workload(seed, vocab):
    """Speculative chaos workload: two vocab-masked repetitive requests
    (the emitted stream repeats, so the n-gram proposer fires and the
    verify program runs before the fault) plus two plain sampled ones
    (the fused-decode fallback path). Returns (prompt, kwargs) pairs +
    the pump schedule."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a, b = (int(t) for t in rng.integers(10, vocab - 10, (2,)))
    va = np.zeros(vocab, bool)
    va[a] = True
    vb = np.zeros(vocab, bool)
    vb[[a, b]] = True
    reqs = [
        (np.full((9,), a, np.int32),
         dict(max_new_tokens=10, temperature=0.8, seed=11,
              logit_mask=va)),
        (np.asarray([a, b] * 5, np.int32),
         dict(max_new_tokens=9, temperature=1.2, seed=7,
              logit_mask=vb)),
        (rng.integers(0, 1000, (5,)).astype(np.int32),
         dict(max_new_tokens=7, temperature=0.6, seed=3)),
        (rng.integers(0, 1000, (6,)).astype(np.int32),
         dict(max_new_tokens=6, temperature=1.0, seed=23)),
    ]
    schedule = (2, 1, 1, 0)
    return reqs, schedule


def _run_kw(server, reqs, schedule):
    handles = []
    for (ids, kw), pump in zip(reqs, schedule):
        handles.append(server.submit(ids, **kw))
        for _ in range(pump):
            server.step()
    while any(not h.finished for h in handles):
        server.step()
    return handles


def _spec_verdict(fault, step, seed, stall_s, device):
    """Speculative engine under chaos: recovered output must equal the
    NON-speculative uninterrupted baseline (token-identity composed
    through rebuild-and-replay), verify must have actually run, pool
    refcounts must balance, and the acceptance counters must survive
    the rebuild."""
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import (Engine, EngineSupervisor,
                                          SpecConfig)

    model = _model(device)
    kw = dict(n_slots=2, max_len=64, min_prompt_bucket=4, do_sample=True,
              top_k=8, block_size=8)
    reqs, schedule = _spec_workload(seed, model.config.vocab_size)

    baseline = _run_kw(Engine(model, **kw), reqs, schedule)
    base_tokens = [list(h.tokens) for h in baseline]

    chaos = ChaosMonkey(seed=seed,
                        at=({int(step): _FAULT_MAP[fault]}
                            if fault != "none" else {}),
                        stall_s=stall_s)
    sup = EngineSupervisor(
        model, chaos=chaos, step_timeout_s=None, kv_probe_interval=1,
        speculative=SpecConfig(draft="ngram", k=4), **kw)
    handles = _run_kw(sup, reqs, schedule)

    survivors = [(i, h) for i, h in enumerate(handles)
                 if h.finish_reason not in ("cancelled",)]
    mismatches = [i for i, h in survivors
                  if list(h.tokens) != base_tokens[i]]
    fired = list(chaos.fired)
    expected_counter = {"stall": sup.wedges + sup.step_errors,
                        "raise": sup.step_errors,
                        "corrupt": sup.kv_corruptions,
                        "abandon": sup.abandoned}.get(fault, 0)
    detected = fault == "none" or (bool(fired) and expected_counter > 0)
    recovered = (fault in ("none", "abandon")
                 or sup.rebuilds > 0) and not mismatches
    idle = (sup.engine.cache.n_active == 0
            and sup.engine.scheduler.queue_depth == 0)
    refcounts_ok = sup.engine.cache.check_refcounts()
    spec_total = sup.spec_counters()
    # the rebuild must not zero acceptance history: when an incarnation
    # was condemned, its pre-fault counters live in sup.spec_totals
    counters_survived = (sup.rebuilds == 0
                         or sup.spec_totals["spec_steps"] > 0)
    ok = bool(detected and recovered and idle and refcounts_ok
              and spec_total["spec_steps"] > 0
              and spec_total["spec_accepted_tokens"] > 0
              and counters_survived)
    return {
        "fault": fault, "injected_step": step, "seed": seed,
        "speculative": {"draft": "ngram", "k": 4},
        "requests": len(reqs), "fired": fired,
        "trace_id": chaos.last_trace_id,
        "rebuilds": sup.rebuilds, "replayed": sup.replayed,
        "wedges": sup.wedges, "step_errors": sup.step_errors,
        "kv_corruptions": sup.kv_corruptions,
        "survivors": len(survivors), "mismatched_requests": mismatches,
        "token_identical": not mismatches,
        "refcounts_consistent": refcounts_ok,
        "spec_counters_total": spec_total,
        "spec_counters_survived_rebuild": counters_survived,
        "acceptance_rate": (
            None if not spec_total["spec_proposed_tokens"]
            else round(spec_total["spec_accepted_tokens"]
                       / spec_total["spec_proposed_tokens"], 4)),
        "ledger": sup.ledger.counts(),
        "ok": ok,
    }


def _fleet_verdict(fault, step, seed, stall_s, n_replicas, device):
    """The fleet robustness headline, both sampling modes: kill / wedge
    / corrupt one of N replicas mid-decode (or flap the router) -- zero
    requests lost, every output token-identical to an uninterrupted
    single-engine baseline, replicas re-registered, pools consistent."""
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import Engine, ReplicaFleet

    model = _model(device)
    reqs, schedule = _workload(seed)
    chaos_fault = _FLEET_FAULT_MAP.get(fault)

    arms = {}
    for arm, sample_kw in (("greedy", {}),
                           ("sampled", dict(do_sample=True, top_k=8))):
        kw = dict(n_slots=2, max_len=64, min_prompt_bucket=4,
                  block_size=8, **sample_kw)
        baseline = _run(Engine(model, **kw), reqs, schedule)
        base_tokens = [list(h.tokens) for h in baseline]

        chaos = ChaosMonkey(seed=seed,
                            at=({int(step): chaos_fault}
                                if chaos_fault else {}),
                            stall_s=stall_s)
        fleet = ReplicaFleet(model, n_replicas, chaos=chaos,
                             kv_probe_interval=1, **kw)
        handles = _run(fleet, reqs, schedule)

        lost = [i for i, h in enumerate(handles)
                if h.finish_reason != "length"]
        mismatches = [i for i, h in enumerate(handles)
                      if list(h.tokens) != base_tokens[i]]
        refcounts_ok = all(
            r.engine.cache.check_refcounts()
            for r in fleet.replicas.values())
        states = fleet.replica_states()
        c = fleet.counters()
        # fault-specific evidence that the injection actually happened
        # and was recovered from (not silently skipped)
        evidence = {
            "kill": c["replica_kills"] > 0 and c["migrations"] > 0,
            "stall": c["migrations"] > 0,
            "raise": c["migrations"] > 0,
            "corrupt": sum(r.sup.kv_corruptions
                           for r in fleet.replicas.values()) > 0,
            "flap": c["route_flaps"] > 0,
            "none": True,
        }[fault]
        arm_ok = (not lost and not mismatches and refcounts_ok
                  and evidence and fleet.n_pending == 0
                  and c["condemned"] == 0
                  and all(s == "healthy" for s in states.values()))
        arms[arm] = {
            "fired": list(chaos.fired), "lost": lost,
            "mismatched_requests": mismatches,
            "token_identical": not mismatches,
            "zero_lost": not lost,
            "migrations": c["migrations"],
            "replica_kills": c["replica_kills"],
            "route_flaps": c["route_flaps"],
            "prefix_routed": c["prefix_routed"],
            "re_registers": c["re_registers"],
            "states": states,
            "refcounts_consistent": refcounts_ok,
            "request_trace_ids": [h.trace_id for h in handles],
            "ledger": fleet.ledger.counts(),
            "ok": bool(arm_ok),
        }
    ok = all(a["ok"] for a in arms.values())
    return {
        "fleet": n_replicas, "fault": fault, "injected_step": step,
        "seed": seed, "requests": len(reqs),
        "token_identical": all(a["token_identical"]
                               for a in arms.values()),
        "zero_lost": all(a["zero_lost"] for a in arms.values()),
        "arms": arms, "ok": bool(ok),
    }


def _tp_worker(out_dir, fault, step, seed, stall_s, step_timeout_s,
               device, backend, confine):
    """One rank of the ``--tp`` verdict: a tp-1 baseline, then the
    supervised tp engine through the fault; writes this rank's record."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import Engine, EngineSupervisor

    torch.set_num_threads(1)
    if device == "cpu" or backend == "gloo":
        dist.init_parallel_env(backend="gloo", device=device or "cuda:0",
                               timeout=300)
    else:
        dist.init_parallel_env(backend="nccl", timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    from paddle_tpu_torch.framework.device import resolve_device
    model = _model(str(resolve_device(None)))
    kw = dict(n_slots=2, max_len=64, min_prompt_bucket=4, do_sample=True,
              top_k=8, block_size=8)
    reqs, schedule = _workload(seed)
    base = [list(h.tokens) for h in _run(Engine(model, **kw), reqs,
                                          schedule)]
    plan = {int(step): _FAULT_MAP[fault]} if fault != "none" else {}
    chaos = ChaosMonkey(seed=seed, at=plan, stall_s=stall_s,
                        ranks=({int(step): confine}
                               if confine is not None and plan else None))
    sup = EngineSupervisor(model, chaos=chaos, tp=world,
                           kv_probe_interval=1,
                           step_timeout_s=step_timeout_s, **kw)
    t0 = time.perf_counter()
    handles = _run(sup, reqs, schedule)
    wall = time.perf_counter() - t0
    rec = dict(rank=rank, base=base, wall_s=wall,
               tokens=[list(map(int, h.tokens)) for h in handles],
               trace_ids=[h.trace_id for h in handles],
               counters=sup.counters(), tp=sup.engine.tp,
               fired=list(chaos.fired),
               ledger=[{k: v for k, v in r.items() if k != "t"}
                       for r in sup.ledger.to_list()],
               refcounts=sup.engine.cache.check_refcounts())
    for t in threading.enumerate():       # abandoned step threads
        if t.name == "supervised-decode":
            t.join(60)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)
    dist.destroy_process_group()


def _tp_verdict(fault, step, seed, stall_s, step_timeout_s, tp, device,
                backend, confine):
    import tempfile

    from paddle_tpu_torch import distributed as dist

    if fault == "stall" and confine is not None:
        # a stall confined to one rank is found by the step timeout
        step_timeout_s = step_timeout_s or 1.0
        stall_s = max(stall_s, 2.5 * step_timeout_s)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        dist.spawn(_tp_worker, args=(d, fault, step, seed, stall_s,
                                     step_timeout_s, device, backend,
                                     confine), nprocs=tp, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(tp):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    same = {k: all(rk[k] == r0[k] for rk in ranks)
            for k in ("tokens", "trace_ids", "counters", "ledger")}
    mismatches = [i for i, (a, b) in enumerate(zip(r0["tokens"],
                                                   r0["base"])) if a != b]
    c = r0["counters"]
    expected = {"stall": c["wedges"] + c["step_errors"],
                "raise": c["step_errors"], "corrupt": c["kv_corruptions"],
                "abandon": c["abandoned"]}.get(fault, 0)
    detected = fault == "none" or expected > 0
    recovered = (fault in ("none", "abandon")
                 or c["rebuilds"] == 1) and not mismatches
    ok = bool(all(same.values()) and detected and recovered
              and all(rk["tp"] == tp and rk["refcounts"] for rk in ranks))
    return {
        "tp": tp, "backend": backend, "fault": fault, "injected_step": step,
        "confined_to_rank": confine, "seed": seed,
        "fired": [rk["fired"] for rk in ranks],
        "rebuilds": c["rebuilds"], "replayed": c["replayed"],
        "counters": c, "ranks_agree": same,
        "mismatched_requests": mismatches,
        "token_identical": not mismatches,
        "supervised_wall_s": [rk["wall_s"] for rk in ranks],
        "spawn_s": spawn_s, "ok": ok,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_chaos_serve",
        description="deterministic serving chaos vs the engine "
        "supervisor / replica fleet (JSON verdict ledger)")
    ap.add_argument("--fault", default="stall",
                    choices=("stall", "raise", "corrupt", "abandon",
                             "kill", "flap", "none"))
    ap.add_argument("--step", type=int, default=4,
                    help="0-based supervised step at which the fault "
                    "fires (mid-decode for the default workload)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stall-s", type=float, default=0.05)
    ap.add_argument("--spec", action="store_true",
                    help="speculative mode: ngram-draft engine under "
                    "the supervisor; verdict = token_identical vs the "
                    "NON-speculative baseline + acceptance counters "
                    "survive the rebuild")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: N supervised replicas behind a "
                    "ReplicaFleet; faults kill/stall/raise/corrupt/"
                    "flap; verdict = zero_lost + token_identical vs a "
                    "single-engine baseline, greedy AND sampled")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; "
                    "'cpu' for the plain PyTorch path)")
    ap.add_argument("--tp", type=int, default=0, metavar="N",
                    help="tensor-parallel mode: N ranks run "
                    "EngineSupervisor(tp=N) in lockstep")
    ap.add_argument("--rank", type=int, default=None,
                    help="with --tp: confine the fault to this rank")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="with --tp: gloo (ranks share one card, or the "
                    "CPU) or nccl (one card a rank)")
    ap.add_argument("--step-timeout-s", type=float, default=None,
                    help="the supervisor's step timeout (a stall "
                    "confined to one rank needs one; default 1.0 then)")
    ap.add_argument("--json", action="store_true", help="emit a JSON line")
    args = ap.parse_args(argv)

    if args.tp:
        if args.fault in ("kill", "flap", "abandon") or args.fleet \
                or args.spec:
            ap.error("--tp takes the stall, raise, corrupt and none faults")
        record = {"bench": "torch_chaos_serve_tp",
                  **_tp_verdict(args.fault, args.step, args.seed,
                                args.stall_s, args.step_timeout_s, args.tp,
                                args.device, args.backend, args.rank)}
        if args.json:
            print(json.dumps(record, default=str))
        else:
            for k in ("tp", "fault", "confined_to_rank", "rebuilds",
                      "ranks_agree", "token_identical"):
                print(f"{k:18s} {record[k]}")
            print("OK (the group recovered as one, token-identical)"
                  if record["ok"] else "FAIL: ranks diverged or did not "
                  "recover token-identically")
        return 0 if record["ok"] else 1

    if args.fleet:
        if args.fault == "abandon":
            ap.error("--fleet has no abandon fault (use the "
                     "single-engine mode)")
        record = {"bench": "torch_chaos_serve_fleet",
                  **_fleet_verdict(args.fault, args.step, args.seed,
                                   args.stall_s, args.fleet,
                                   args.device)}
        if args.json:
            print(json.dumps(record, default=str))
        else:
            for k in ("fault", "injected_step", "requests",
                      "token_identical", "zero_lost"):
                print(f"{k:18s} {record[k]}")
            for arm, a in record["arms"].items():
                print(f"{arm:>8s}: migrations={a['migrations']} "
                      f"kills={a['replica_kills']} states={a['states']}")
            print("OK (fleet recovered, token-identical, zero lost)"
                  if record["ok"] else
                  "FAIL: fleet lost requests or diverged")
        return 0 if record["ok"] else 1

    if args.fault in ("kill", "flap"):
        ap.error(f"--fault {args.fault} requires --fleet N")
    if args.spec:
        record = {"bench": "torch_chaos_serve_spec",
                  **_spec_verdict(args.fault, args.step, args.seed,
                                  args.stall_s, args.device)}
        if args.json:
            print(json.dumps(record, default=str))
        else:
            for k in ("fault", "injected_step", "requests", "rebuilds",
                      "replayed", "survivors", "token_identical",
                      "acceptance_rate",
                      "spec_counters_survived_rebuild"):
                print(f"{k:30s} {record[k]}")
            print("OK (speculative run recovered token-identically)"
                  if record["ok"] else
                  "FAIL: speculative run diverged or lost acceptance "
                  "counters")
        return 0 if record["ok"] else 1
    record = {"bench": "torch_chaos_serve",
              **_verdict(args.fault, args.step, args.seed, args.stall_s,
                         args.device)}
    if args.json:
        print(json.dumps(record, default=str))
    else:
        for k in ("fault", "injected_step", "requests", "rebuilds",
                  "replayed", "survivors", "token_identical"):
            print(f"{k:18s} {record[k]}")
        print("OK (recovered, token-identical)" if record["ok"]
              else "FAIL: did not recover token-identically")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
