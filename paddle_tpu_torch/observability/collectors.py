"""Pull-time collectors: the port's existing counter sources (the serving
engines and their paged KV pools, the replica fleets, the train and
serving flight ledgers, the engine supervisors and the comm-opt train
steps) exported through the metrics registry without touching their hot
paths. Counterpart of ``paddle_tpu/observability/collectors.py``: the
same family names, kinds, labels and help strings.

The ``dispatch`` and ``aot`` families are not registered: the port has
no eager dispatch cache and no AOT service yet (ROADMAP.md, port queue:
runtime services).

Each collector imports its source lazily and tolerates the subsystem
being unused (empty families, never an import at module load: the
observability package must be importable before everything else).
"""
from __future__ import annotations

from .metrics import DEFAULT_LATENCY_BUCKETS, register_collector


def _fam(name, kind, help, samples):
    return {"name": name, "kind": kind, "help": help, "samples": samples}


def _serving_families():
    from ..serving import metrics as sm

    t = sm.global_counters()
    counter_keys = (
        "requests_submitted", "requests_completed", "requests_rejected",
        "requests_timed_out", "requests_cancelled", "requests_shed",
        "tokens_generated", "prefills", "decode_steps", "preemptions",
        "chunked_prefills", "chunk_steps", "prefix_hit_tokens",
        "prompt_tokens", "cow_copies", "spec_steps", "draft_steps",
        "spec_proposed_tokens", "spec_accepted_tokens",
        "spec_emitted_tokens")
    yield _fam("paddle_serving_events_total", "counter",
               "serving-engine counters summed across live engines",
               [({"kind": k}, t[k]) for k in counter_keys])
    gauges = [("engines", t["engines"]),
              ("peak_queue_depth", t["peak_queue_depth"]),
              ("peak_active", t["peak_active"])]
    if t["prefix_hit_rate"] is not None:
        gauges.append(("prefix_hit_rate", t["prefix_hit_rate"]))
    if t.get("spec_acceptance_rate") is not None:
        gauges.append(("spec_acceptance_rate",
                       t["spec_acceptance_rate"]))
    if t["pool_low_watermark"] is not None:
        gauges.append(("pool_low_watermark", t["pool_low_watermark"]))
    yield _fam("paddle_serving_gauge", "gauge",
               "serving-engine point-in-time values",
               [({"kind": k}, v) for k, v in gauges])
    # merged ITL histogram across live engines (same bucket bounds)
    counts = [0] * (len(DEFAULT_LATENCY_BUCKETS) + 1)
    total_sum, total_count = 0.0, 0
    for ref in list(sm._ENGINES):
        m = ref()
        if m is None or getattr(m, "itl_hist", None) is None:
            continue
        s, c = m.itl_hist.merge_counts(counts)
        total_sum += s
        total_count += c
    if total_count:
        cum, buckets = 0, []
        for b, c in zip(DEFAULT_LATENCY_BUCKETS, counts):
            cum += c
            buckets.append((b, cum))
        buckets.append((float("inf"), cum + counts[-1]))
        yield {"name": "paddle_serving_itl_seconds", "kind": "histogram",
               "help": "decode-step wall time (= inter-token latency) "
                       "across live engines",
               "buckets": buckets, "sum": total_sum,
               "count": total_count}


def _fleet_families():
    from ..serving import fleet as fl

    t = fl.global_counters()
    yield _fam("paddle_serving_fleets", "gauge",
               "live replica fleets", [({}, t["fleets"])])
    if not t["fleets"]:
        return
    counter_keys = ("routed", "prefix_routed", "migrations", "failovers",
                    "replica_kills", "route_flaps", "fleet_sheds",
                    "backoffs", "retries", "re_registers")
    yield _fam("paddle_serving_fleet_events_total", "counter",
               "fleet routing/failover/migration counters summed "
               "across live fleets",
               [({"kind": k}, t[k]) for k in counter_keys])
    # the replica health state machine, one gauge child per replica:
    # 0=healthy 1=degraded 2=draining 3=condemned (REPLICA_STATES order)
    samples = []
    for f in fl.live_fleets():
        for rid, state in f.replica_states().items():
            samples.append(({"fleet": f.name, "replica": rid},
                            fl.REPLICA_STATES.index(state)))
    if samples:
        yield _fam("paddle_serving_replica_state", "gauge",
                   "replica health state "
                   "(0=healthy 1=degraded 2=draining 3=condemned)",
                   samples)


def _resilience_families():
    from ..resilience import ledger

    for scope in ("train", "serving", "fleet"):
        t = ledger.global_counters(scope=scope)
        n = t.pop("ledgers", 0)
        yield _fam(f"paddle_resilience_{scope}_ledgers", "gauge",
                   f"live {scope}-scope flight ledgers", [({}, n)])
        if t:
            yield _fam(
                f"paddle_resilience_{scope}_events_total", "counter",
                f"{scope} flight-ledger events by kind",
                [({"event": k}, v) for k, v in sorted(t.items())])


def _serving_resilience_families():
    from ..serving import resilience as sr

    t = sr.global_counters()
    n = t.pop("supervisors", 0)
    yield _fam("paddle_serving_supervisors", "gauge",
               "live engine supervisors", [({}, n)])
    yield _fam("paddle_serving_resilience_events_total", "counter",
               "engine-supervisor counters summed across live "
               "supervisors",
               [({"kind": k}, v) for k, v in sorted(t.items())])


def _comm_families():
    from ..distributed.comm_opt import global_comm_stats

    s = global_comm_stats()
    if not s["steps"]:
        return
    yield _fam("paddle_comm_opt_steps", "gauge",
               "live comm-opt train steps", [({}, s["steps"])])
    # the byte COUNTERS live on the registry directly
    # (paddle_collective_bytes_total); the per-arm ratio is a pull-time
    # gauge because it is a static property of each live step's config
    yield _fam(
        "paddle_comm_compression_ratio", "gauge",
        "fp32 gradient-exchange bytes / actual wire bytes per live "
        "comm-opt step",
        [({"arm": str(i),
           "compress": a["grad_compress"] or "none",
           "zero1": "1" if a["zero1"] else "0",
           "tp": str(a["tp"])}, a["compression_ratio"])
         for i, a in enumerate(s["arms"])])


def install_default_collectors():
    """Attach the built-in sources to the default registry (idempotent:
    re-registration under the same name replaces)."""
    register_collector(_serving_families, "serving")
    register_collector(_fleet_families, "fleet")
    register_collector(_resilience_families, "resilience")
    register_collector(_serving_resilience_families, "serving_resilience")
    register_collector(_comm_families, "comm_opt")
