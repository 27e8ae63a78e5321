"""The PyTorch port's observability surface (``paddle_tpu_torch.
observability`` and ``paddle_tpu_torch.profiler``) against the JAX
package's.

The cases of ``tests/test_observability.py`` that exist in the port
(leaving out the two compile-attribution tests and the ``analysis/``
lint rule), on the tiny fp32 Llama (2 layers) built in the JAX package
and carried into the port through numpy:

- the registry's units, the Prometheus text and the JSON snapshot; the
  same registry operations give the same exposition text in both
  packages;
- the span tracer's nesting, ids, ring bound and Chrome export, and the
  disabled tracer recording nothing;
- the same workload through both packages with tracing on gives the same
  sequence of span names, categories and args (times and ids aside): the
  serving lifecycle, the replay after ``decode-raise`` (``replay_k`` 0
  then > 0 under one trace id), the train phases and the data spans;
- ``to_prometheus()`` of the same serving and fleet workload gives the
  same families and, for every sample that is not a wall time, the same
  values;
- the profiler: ``make_scheduler``'s states, ``Benchmark.step_info``'s
  format, ``RecordEvent`` and ``export_chrome_tracing`` on the CPU giving
  a trace that ``load_profiler_result`` reads back, the summary lines;
- ``tools/torch_obs_dump.py --json`` and the disabled-tracer smoke.
"""
import dataclasses
import gc
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.observability as jobs
import paddle_tpu.distributed.comm_opt  # noqa: F401  (the bytes counter)
import paddle_tpu.profiler as jprofiler
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.resilience import ChaosMonkey as JChaos
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineSupervisor as JSupervisor
from paddle_tpu.serving import ReplicaFleet as JFleet
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed.comm_opt  # noqa: F401
import paddle_tpu_torch.observability as obs
import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.resilience import ChaosMonkey
from paddle_tpu_torch.serving import (Engine, EngineOverloaded,
                                      EngineSupervisor, ReplicaFleet)
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(LLAMA_TINY, dtype="float32", num_hidden_layers=2)
GREEDY = dict(n_slots=2, max_len=64, min_prompt_bucket=4)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with its weights), one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    jpaddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=2))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, {k: np.array(v._data)
                               for k, v in jm.state_dict().items()})
    yield jm, tm.eval()
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Every test starts with both tracers off and empty rings."""
    for t in (tracing, jtracing):
        t.disable()
        t.reset()
    yield
    for t in (tracing, jtracing):
        t.disable()
        t.reset()


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _obs_dump():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_obs_dump
    finally:
        sys.path.pop(0)
    return torch_obs_dump


def _sequence(ring, keep=None):
    """The ring's spans as (name, cat, phase, args), times and ids aside;
    ``keep`` filters by name prefix. The JAX package's compile spans
    (``xla.*``) have no counterpart and are left out."""
    out = []
    for s in ring:
        if s["name"].startswith("xla."):
            continue
        if keep is not None and not s["name"].startswith(keep):
            continue
        out.append((s["name"], s["cat"], s["ph"],
                    tuple(sorted((s["args"] or {}).items()))))
    return out


def _traces(ring, keep):
    """Each kept span's trace id, renamed in order of first appearance
    (so the two packages' id patterns compare)."""
    names = {}
    return [names.setdefault(s["trace"], len(names)) for s in ring
            if s["name"].startswith(keep)]


# ---------------------------------------------------------------------------
# metrics registry units
# ---------------------------------------------------------------------------

def _registry_ops(m):
    reg = m.MetricsRegistry()
    c = m.Counter("t_requests_total", "x", labelnames=("kind",),
                  registry=reg)
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc()
    g = m.Gauge("t_depth", "x", registry=reg)
    g.set(3)
    g.inc()
    g.dec(2)
    h = m.Histogram("t_lat_seconds", "lat", window=8, registry=reg)
    for v in (0.0003, 0.002, 0.002, 0.7, 12.0):
        h.observe(v)
    return reg, c, g


def test_counter_gauge_units_and_the_jax_exposition():
    reg, c, g = _registry_ops(obs_metrics)
    assert c.value == 4 and g.value == 2
    with pytest.raises(ValueError):
        c.labels(kind="a").inc(-1)          # counters only go up
    with pytest.raises(ValueError):
        c.labels(wrong="a")                 # label names enforced
    with pytest.raises(ValueError):
        c.inc()                             # labeled: must go via labels
    with pytest.raises(ValueError):
        obs_metrics.Counter("t_depth", "collides", registry=reg)
    with pytest.raises(ValueError):
        obs_metrics.Counter("bad name!", registry=reg)
    fams = {f["name"]: f for f in reg.collect()}
    assert fams["t_requests_total"]["samples"] == [
        ({"kind": "a"}, 3.0), ({"kind": "b"}, 1.0)]
    jreg, _, _ = _registry_ops(jmetrics)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.snapshot() == jreg.snapshot()


def test_histogram_percentile_window_and_cumulative():
    got, want = [], []
    for m, out in ((obs_metrics, got), (jmetrics, want)):
        h = m.Histogram("t_lat_seconds", window=64, registry=None)
        out.append((h.percentile(50), h.percentile(95)))
        for _ in range(8):
            h.observe(0.5)
        out.append((h.percentile(50), h.percentile(95)))
        for _ in range(64):
            h.observe(0.001)
        out.append((h.percentile(95), h.cumulative(), h.count, h.sum))
    assert got == want
    assert got[0] == (None, None)
    assert got[1][0] > 0.25 and got[1][1] > 0.25
    p95, buckets, count, total = got[2]
    assert p95 < 0.01                # the window forgot the slow ones
    assert buckets[-1] == (float("inf"), 72) and count == 72
    cums = [c for _, c in buckets]
    assert cums == sorted(cums)
    assert abs(total - (8 * 0.5 + 64 * 0.001)) < 1e-9


def test_prometheus_text_parses_and_snapshot_serializable(pair):
    _, tm = pair
    eng = Engine(tm, **GREEDY)
    eng.submit(_prompts([5], seed=0)[0], max_new_tokens=4)
    eng.drain()
    text = obs.to_prometheus()
    bad = _obs_dump().prom_parses(text)
    assert not bad, f"malformed exposition lines: {bad[:5]}"
    assert "paddle_serving_events_total" in text
    assert "paddle_serving_itl_seconds_bucket" in text
    snap = obs.snapshot()
    json.dumps(snap)
    assert snap["paddle_serving_itl_seconds"]["count"] > 0
    cums = [c for _, c in snap["paddle_serving_itl_seconds"]["buckets"]]
    assert cums == sorted(cums)


def test_collector_failure_is_reported_not_fatal():
    reg = obs_metrics.MetricsRegistry()

    def broken():
        raise RuntimeError("scrape me not")
        yield  # pragma: no cover

    reg.collector(broken, "broken")
    fams = {f["name"]: f for f in reg.collect()}
    errs = fams["paddle_collector_errors"]["samples"]
    assert errs and "RuntimeError" in errs[0][0]["error"]


def test_compile_attribution_waits_for_runtime_services():
    assert set(obs.__all__) == set(jobs.__all__) - {
        "compile_scope", "compile_summary", "compiles_by_origin"}
    for name in ("compile_scope", "compile_summary", "compiles_by_origin"):
        with pytest.raises(NotImplementedError, match="runtime services"):
            getattr(obs, name)()


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

def test_span_nesting_ids_and_ring_bound():
    tracing.enable(ring=4)
    try:
        with obs.span("outer") as outer_tok:
            with obs.span("inner"):
                assert tracing.current_trace_id() is not None
        inner, outer = obs.spans()
        assert inner["name"] == "inner" and outer["name"] == "outer"
        assert inner["trace"] == outer["trace"]      # inherited
        assert inner["parent"] == outer["span"]
        assert outer["parent"] is None
        assert outer_tok.trace == outer["trace"]
        assert re.fullmatch(r"[0-9a-f]+-[0-9a-f]+", outer["trace"])
        for i in range(10):
            with obs.span(f"s{i}"):
                pass
        assert [s["name"] for s in obs.spans()] == ["s6", "s7", "s8", "s9"]
    finally:
        tracing.ring_size(8192)


def test_disabled_tracer_records_nothing():
    assert not tracing.enabled()
    with obs.span("ghost", attr=1) as tok:
        assert tok is None
    obs.instant("ghost-instant")
    obs.span_event("ghost-event", 0.0, 1.0)
    assert obs.spans() == []
    assert tracing.current_trace_id() is None
    # disabled: no torch hooks installed, Tensor.backward is torch's own
    assert tracing._HOOKS is None
    assert not hasattr(torch.Tensor.backward, "__wrapped__")


def test_chrome_trace_export_shape():
    tracing.enable()
    with obs.span("a", cat="test", k="v"):
        obs.instant("marker", cat="test")
    doc = obs.to_chrome_trace()
    json.loads(json.dumps(doc))
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"
    xs = [e for e in evs if e["ph"] == "X"]
    ins = [e for e in evs if e["ph"] == "i"]
    assert len(xs) == 1 and len(ins) == 1
    assert xs[0]["name"] == "a" and xs[0]["dur"] >= 0
    assert {"ts", "pid", "tid", "args"} <= set(xs[0])
    assert xs[0]["args"]["k"] == "v" and xs[0]["args"]["trace_id"]


# ---------------------------------------------------------------------------
# serving request lifecycle + supervisor rebuild, against the JAX package
# ---------------------------------------------------------------------------

def _lifecycle(engine_cls, model, tr):
    tr.enable()
    tr.reset()
    eng = engine_cls(model, **GREEDY)
    h = eng.submit(_prompts([5], seed=1)[0], max_new_tokens=4)
    eng.drain()
    ring = tr.spans()
    tr.disable()
    return h, ring


def test_serving_request_trace_full_lifecycle_equals_jax(pair):
    jm, tm = pair
    h, ring = _lifecycle(Engine, tm, tracing)
    jh, jring = _lifecycle(JEngine, jm, jtracing)
    assert list(h.tokens) == list(jh.tokens)
    assert _sequence(ring, "serving.") == _sequence(jring, "serving.")
    assert _traces(ring, "serving.") == _traces(jring, "serving.")
    by_name = {}
    for s in ring:
        by_name.setdefault(s["name"], []).append(s)
    for phase in ("serving.submit", "serving.queue", "serving.prefill",
                  "serving.decode", "serving.finish"):
        assert by_name[phase][0]["trace"] == h.trace_id, phase
    assert "serving.decode_step" in by_name
    assert by_name["serving.finish"][0]["args"]["reason"] == "length"
    doc = json.loads(json.dumps(obs.to_chrome_trace()))
    assert any(e.get("args", {}).get("trace_id") == h.trace_id
               for e in doc["traceEvents"])


def _replay(sup_cls, chaos_cls, model, tr):
    tr.enable()
    tr.reset()
    chaos = chaos_cls(seed=0, at={2: "decode-raise"})
    sup = sup_cls(model, chaos=chaos, **GREEDY)
    h = sup.submit(_prompts([5], seed=2)[0], max_new_tokens=6)
    h.result()
    ring = tr.spans()
    tr.disable()
    return sup, chaos, h, ring


def test_replay_span_carries_original_trace_id_equals_jax(pair):
    jm, tm = pair
    sup, chaos, h, ring = _replay(EngineSupervisor, ChaosMonkey, tm,
                                  tracing)
    _, _, jh, jring = _replay(JSupervisor, JChaos, jm, jtracing)
    assert list(h.tokens) == list(jh.tokens)
    keep = ("serving.", "chaos.")
    assert _sequence(ring) == [s for s in _sequence(jring)
                               if s[0].startswith(keep)]
    assert sup.rebuilds == 1 and h.finish_reason == "length"
    prefills = [s for s in ring if s["name"] == "serving.prefill"
                and s["args"]["request_id"] == h.request_id]
    assert len(prefills) == 2
    assert prefills[0]["trace"] == prefills[1]["trace"] == h.trace_id
    assert prefills[0]["args"]["replay_k"] == 0
    assert prefills[1]["args"]["replay_k"] > 0      # key-chain fast-forward
    adopts = [s for s in ring if s["name"] == "serving.adopt"]
    assert adopts and adopts[0]["trace"] == h.trace_id
    faults = [s for s in ring if s["name"] == "chaos.decode-raise"]
    assert faults and faults[0]["trace"] == chaos.last_trace_id
    rebuilds = [r for r in sup.ledger.to_list() if r["event"] == "rebuild"]
    assert rebuilds[0]["trace_id"] == chaos.last_trace_id
    assert h.trace_id in rebuilds[0]["request_traces"]
    doc = json.loads(json.dumps(obs.to_chrome_trace()))
    assert sum(1 for e in doc["traceEvents"]
               if e.get("args", {}).get("trace_id") == h.trace_id) >= 4


def test_retry_after_hint_histogram_p95_and_cold_default(pair):
    _, tm = pair
    eng = Engine(tm, n_slots=1, max_len=64, min_prompt_bucket=4,
                 max_queue=1, default_retry_after_s=1.0)
    assert eng.metrics.itl_p95() is None
    assert eng._retry_after_hint() == 1.0
    h = eng.submit(_prompts([5], seed=3)[0], max_new_tokens=8)
    eng.step()
    eng.step()
    p95 = eng.metrics.itl_p95()
    assert p95 is not None and p95 > 0
    remaining = h.max_new_tokens - len(h.tokens)
    assert eng._retry_after_hint() == round(p95 * remaining, 3)
    eng.submit(_prompts([5], seed=4)[0], max_new_tokens=8)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(_prompts([5], seed=5)[0], max_new_tokens=8)
    assert ei.value.retry_after_s == eng._retry_after_hint()
    eng.drain()


# ---------------------------------------------------------------------------
# the registry after the same serving and fleet workload in both packages
# ---------------------------------------------------------------------------

# families of the JAX package with no counterpart source in the port
_JAX_ONLY = re.compile(r"^paddle_(dispatch|aot|xla|compile)_")
# samples that are wall times (or derived from them)
_WALL = {"paddle_serving_itl_seconds"}


def _scrape_workload(engine_cls, fleet_cls, model, obs_mod):
    gc.collect()
    eng = engine_cls(model, **GREEDY)
    for p in _prompts([5, 9, 3], seed=6):
        eng.submit(p, max_new_tokens=5)
    eng.drain()
    # a fleet name of its own: the default names count the process's
    # fleets, which differ between the packages
    fleet = fleet_cls(model, 2, name="obs-fleet", **GREEDY)
    hs = [fleet.submit(p, max_new_tokens=4)
          for p in _prompts([4, 6, 7], seed=7)]
    fleet.step()
    fleet.kill_replica(hs[0].replica_id)
    while any(not h.finished for h in hs):
        fleet.step()
    snap = obs_mod.snapshot()
    text = obs_mod.to_prometheus()
    toks = [list(h.tokens) for h in hs]
    del eng, fleet, hs
    gc.collect()
    return snap, text, toks


def test_prometheus_serving_and_fleet_families_equal_jax(pair):
    jm, tm = pair
    snap, text, toks = _scrape_workload(Engine, ReplicaFleet, tm, obs)
    jsnap, _, jtoks = _scrape_workload(JEngine, JFleet, jm, jobs)
    assert toks == jtoks
    assert not _obs_dump().prom_parses(text)
    want = {k: v for k, v in jsnap.items() if not _JAX_ONLY.match(k)}
    assert set(snap) == set(want)
    for name, fam in want.items():
        got = snap[name]
        assert got["kind"] == fam["kind"], name
        if fam["kind"] == "histogram":
            assert got["count"] == fam["count"], name
            continue
        if name in _WALL:
            continue
        if name == "paddle_serving_replica_state":
            # one sample a replica of every live fleet: this workload's
            got, fam = ({"samples": [x for x in f["samples"]
                                     if x["labels"]["fleet"] == "obs-fleet"]}
                        for f in (got, fam))
            assert len(got["samples"]) == 2
        assert got["samples"] == fam["samples"], name
    for fam in ("paddle_serving_events_total",
                "paddle_serving_fleet_events_total",
                "paddle_serving_replica_state",
                "paddle_serving_resilience_events_total"):
        assert fam in snap, fam
    tokens = {s["labels"]["kind"]: s["value"]
              for s in snap["paddle_serving_events_total"]["samples"]}
    assert tokens["tokens_generated"] >= sum(map(len, toks))


# ---------------------------------------------------------------------------
# train phase and data spans, against the JAX package
# ---------------------------------------------------------------------------

def _train_phases(pkg, tr):
    tr.enable()
    tr.reset()
    pkg.seed(0)
    net = pkg.nn.Sequential(pkg.nn.Linear(8, 8), pkg.nn.ReLU(),
                            pkg.nn.Linear(8, 4))
    opt = pkg.optimizer.Adam(learning_rate=1e-3,
                             parameters=net.parameters())
    x = pkg.to_tensor(np.ones((4, 8), np.float32))
    y = pkg.to_tensor(np.zeros((4,), np.int64))
    loss = pkg.nn.functional.cross_entropy(net(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    ring = tr.spans()
    tr.disable()
    return ring


def test_train_phase_spans_equal_jax():
    from paddle_tpu_torch.framework import device as dmod
    before = dmod._current_device
    paddle.set_device("cpu")
    try:
        ring = _train_phases(paddle, tracing)
    finally:
        dmod._current_device = before   # the next test's default stays
    jring = _train_phases(jpaddle, jtracing)
    assert _sequence(ring, "train.") == _sequence(jring, "train.")
    names = {s["name"] for s in ring}
    assert {"train.forward", "train.backward", "train.optimizer"} <= names
    fwd = [s for s in ring if s["name"] == "train.forward"]
    assert len(fwd) == 1 and fwd[0]["args"]["layer"] == "Sequential"
    # disabled again: the torch hooks are gone
    assert tracing._HOOKS is None


def test_dataloader_emits_data_spans_equal_jax():
    from paddle_tpu.io import DataLoader as JLoader
    from paddle_tpu.io import TensorDataset as JDataset
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    counts = []
    for tr, ds, loader in (
            (tracing, TensorDataset([torch.arange(8, dtype=torch.float32)]),
             lambda d: DataLoader(d, batch_size=4, device="cpu")),
            (jtracing, JDataset([jpaddle.to_tensor(
                np.arange(8, dtype=np.float32))]),
             lambda d: JLoader(d, batch_size=4))):
        tr.enable()
        tr.reset()
        n = sum(1 for _ in loader(ds))
        spans = [s for s in tr.spans() if s["name"] == "train.data"]
        tr.disable()
        assert n >= 1 and len(spans) >= n
        counts.append((n, _sequence(spans)))
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_make_scheduler_states_equal_jax():
    for kw in (dict(closed=1, ready=1, record=2, repeat=2),
               dict(closed=0, ready=0, record=3, skip_first=2),
               dict(closed=2, ready=0, record=1)):
        got = [profiler.make_scheduler(**kw)(s).name for s in range(12)]
        want = [jprofiler.make_scheduler(**kw)(s).name for s in range(12)]
        assert got == want, kw


def test_benchmark_step_info_format_equals_jax(monkeypatch):
    from paddle_tpu.profiler import timer as jtimer
    from paddle_tpu_torch.profiler import timer

    out = []
    for mod in (timer, jtimer):
        clock = iter([0.0, 0.1, 0.4, 1.0, 1.2, 1.35, 2.0])
        monkeypatch.setattr(mod.timeit, "default_timer",
                            lambda: next(clock))
        b = mod.Benchmark()
        b.begin()
        b.before_reader()
        b.after_reader()
        b.step(num_samples=8)
        b.before_reader()
        b.after_reader()
        b.step(num_samples=8)
        out.append(b.step_info("samples"))
    assert out[0] == out[1]
    assert "reader_cost" in out[0] and "ips" in out[0]


def test_profiler_record_event_export_and_load(tmp_path, capsys):
    from paddle_tpu_torch.profiler import profiler_statistic as ps
    from paddle_tpu_torch.profiler import utils as putils

    tracing.enable()
    assert not putils.in_profiler_mode()
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU],
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path), "w0"))
    prof.start()
    assert putils.in_profiler_mode()
    with profiler.RecordEvent("custom-range"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    profiler.RecordInstantEvent("ping").begin()
    prof.step()
    prof.stop()
    assert not putils.in_profiler_mode()
    assert os.listdir(tmp_path) == ["w0.pt.trace.json"]
    res = profiler.load_profiler_result(str(tmp_path))
    ann = res.annotation_summary()
    assert ann["custom-range"]["calls"] == 1 and "ping" in ann
    assert "aten::mm" in res.op_summary()
    stats = ps.gather_span_statistic()
    assert stats["user::custom-range"]["calls"] == 1
    table = ps.build_span_summary(sorted_by=ps.SortedKeys.CPUTotal)
    assert "user::custom-range" in table and "Span Summary" in table
    prof.summary()
    out = capsys.readouterr().out
    assert "Span Summary" in out and "UserDefined Summary" in out
    tracing.disable()
    putils.wrap_optimizers()
    assert tracing.enabled()
    tracing.disable()


def test_profile_completeness_and_the_window_flush(tmp_path, monkeypatch):
    # a CPU-only window closes without the device flush
    monkeypatch.setattr(profiler, "_flush_device_records",
                        lambda: pytest.fail("flushed a CPU-only window"))
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    prof._export_dir = str(tmp_path / "cpu")
    prof.start()
    torch.ones(4) + 1
    prof.stop()
    # tools/torch_profile_check.py: launch calls whose device record the
    # trace lacks, by half of the run
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_profile_check
    finally:
        sys.path.pop(0)

    def call(c, name="cudaLaunchKernel"):
        return dict(ph="X", cat="cuda_runtime", name=name, ts=c, dur=1,
                    args=dict(correlation=c))

    def rec(c, name):
        return dict(ph="X", cat="kernel", name=name, ts=c, dur=1,
                    args=dict(correlation=c))

    evs = [call(1), call(2, "cudaMemcpyAsync"), call(3), call(4),
           call(5, "cudaStreamSynchronize"),
           rec(1, "flash_decode_split_kernel"), rec(3, "gemm<float>(int)"),
           dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=2, dur=1,
                args=dict(correlation=2))]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    assert torch_profile_check.completeness(str(path)) == dict(
        calls=4, records=3, missing_first_half=0, missing_second_half=1,
        flash_decode_records=1)


def test_profiler_counter_lines_and_refusals(pair):
    from paddle_tpu_torch.profiler.statistic import kernel_name

    _, tm = pair
    sup = EngineSupervisor(tm, chaos=ChaosMonkey(at={1: "decode-raise"}),
                           **GREEDY)
    sup.submit(_prompts([5], seed=8)[0], max_new_tokens=4).result()
    lines = profiler.counter_lines()
    assert any(ln.startswith("serving: ") for ln in lines)
    sv = [ln for ln in lines if ln.startswith("serving-resilience: ")]
    assert sv and "rebuilds=" in sv[0]
    assert profiler.serving_resilience_counters()["rebuilds"] >= 1
    with pytest.raises(NotImplementedError, match="item 9"):
        profiler.dispatch_counters()
    with pytest.raises(NotImplementedError, match="runtime services"):
        profiler.aot_counters()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiler.Profiler(targets=[profiler.ProfilerTarget.GPU])
    with pytest.raises(ValueError, match="no target"):
        profiler.Profiler(targets=[])
    with pytest.raises(ValueError, match="CPU and CUDA"):
        profiler.Profiler(targets=[profiler.ProfilerTarget.TPU])
    # CUPTI's demangled names (as read from an H100 trace of the engine)
    for raw, want in (
            ("void (anonymous namespace)::flash_decode_split_kernel<"
             "__nv_bfloat16, 128, 1>(__nv_bfloat16 const*, int const*, "
             "float*, int, float)", "flash_decode_split_kernel"),
            ("void at::native::elementwise_kernel<128, 2, at::native::"
             "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, "
             "float, float, at::native::binary_internal::MulFunctor<float> "
             "> >(at::TensorIteratorBase&, at::native::BinaryFunctor<float,"
             " float, float> const&)::{lambda(int)#1}>(int, at::native::"
             "gpu_kernel_impl_nocast<float>(at::TensorIteratorBase&)::"
             "{lambda(int)#1})", "elementwise_kernel"),
            ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT",
             "nvjet_tst_64x8_64x16_4x1_v_bz_NNT"),
            ("int8_tc_kernel", "int8_tc_kernel")):
        assert kernel_name(raw) == want, raw
    assert set(profiler.__all__) == set(jprofiler.__all__)


# ---------------------------------------------------------------------------
# the CLI and the disabled path
# ---------------------------------------------------------------------------

def test_obs_dump_cli_smoke(tmp_path, capsys):
    trace_file = str(tmp_path / "trace.json")
    rc = _obs_dump().main(["--json", "--demo", "--device", "cpu",
                           "--trace", trace_file])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"]
    assert rec["families"] >= 4 and not rec["prom_malformed_lines"]
    assert rec["spans_recorded"] > 0
    doc = json.load(open(trace_file))
    assert "traceEvents" in doc
    tracing.disable()


def test_disabled_overhead_smoke():
    import time as _time

    assert not tracing.enabled()
    t0 = _time.perf_counter()
    for _ in range(100_000):
        if tracing._ENABLED:          # the instrumentation-site guard
            raise AssertionError("tracer unexpectedly enabled")
    branch_wall = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    for _ in range(10_000):
        with obs.span("noop"):
            pass
    cm_wall = _time.perf_counter() - t0
    assert obs.spans() == []
    assert branch_wall < 1.0 and cm_wall < 2.0
