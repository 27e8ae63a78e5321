"""Tensor-parallel serving of the PyTorch port (``Engine(model, tp=N)``)
against the JAX package's ``Engine(tp=N)``.

Both sides serve the JAX models' weights (LLAMA_TINY cut to 2 layers, as
``tests/test_serving_tp.py``'s, and GPT_TINY; fp32), carried into the port
through numpy. The JAX engines run on the conftest's 8 virtual CPU
devices in this process; the port's tp engines run on gloo ranks on the
CPU, one module-scoped spawn of 4 ranks and one of 2
(``torch_dist_worker.serving_tp_worker``), each rank serving every
workload in the SPMD way (the same calls on every rank). The port's tp=1
engine and ``generate`` run here.

- construction refuses what the JAX engine refuses, with its messages:
  the slot layout, a tp that does not divide the model, ``mesh=``
  without tp, a mesh whose tp axis is not tp, and ``flash_decode``;
- tp=4, greedy and sampled (``tests/test_serving_tp.py:77``, :97):
  tokens equal to the JAX tp engine's, the port's tp=1 engine's and
  ``generate``'s, and a sampled request adopted mid-flight by a fresh
  tp=4 engine finishes with the same tokens;
- tp=2, chunked prefill + prefix sharing + preemption (:138), and GPT
  greedy and sampled + chunked: the same identities, the paged machinery
  really exercised, refcounts held;
- every rank emits the same tokens;
- each tp body (prefill, paged decode, chunk; Llama and GPT) on layer 0
  gives the JAX tp body's hidden state within 1e-5 relative;
- a rank whose clock runs ahead cannot expire a request alone: rank 0's
  clock decides for both (a split decision would hang the ranks, and the
  spawn's timeout would fail the test);
- ``stats()["mesh"]`` and the collectives one decode step issues, and
  the submit guard against ranks that disagree.
"""
import dataclasses
import pickle

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
import torch_dist_worker as W
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.text import generation as JG
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.serving import Engine

GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8)
V = 1024                     # LLAMA_TINY's and GPT_TINY's vocabulary
REL_TOL = 1e-5               # fp32 bodies, other reduction orders


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (n,)).astype(np.int32) for n in lens]


def _shared(seed, sys_len, lens):
    """Prompts sharing a ``sys_len``-token system prefix."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, V, (sys_len,)).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, V, (n,)).astype(
        np.int32)]) for n in lens]


# each job: the tp degree, the model, the engine's arguments and the
# workload (torch_dist_worker.run_workload)
JOBS = {
    "llama greedy": dict(
        tp=4, arch="llama", engine=GEO,
        workload=dict(prompts=_prompts((3, 5, 4)), max_new=6)),
    "llama sampled": dict(
        tp=4, arch="llama", engine=dict(GEO, do_sample=True, top_k=8),
        workload=dict(prompts=_prompts((3, 4, 2), seed=1), max_new=6,
                      common=dict(temperature=0.9, seed=123))),
    # a pool of 7 usable blocks: a chunked prompt, a shared prefix and a
    # preemption (replayed)
    "llama chunked shared preempted": dict(
        tp=2, arch="llama", engine=dict(GEO, prefill_chunk=16, n_blocks=8),
        workload=dict(prompts=_shared(7, 16, (4, 4, 4, 4)), max_new=12)),
    "gpt greedy": dict(
        tp=2, arch="gpt", engine=GEO,
        workload=dict(prompts=_shared(7, 18, (3, 6, 4, 9)), max_new=5,
                      staggered=True)),
    "gpt sampled chunked": dict(
        tp=2, arch="gpt",
        engine=dict(GEO, do_sample=True, top_k=8, top_p=0.9,
                    prefill_chunk=8),
        workload=dict(prompts=_shared(3, 16, (13, 2, 21, 5)), max_new=6,
                      staggered=True,
                      kwargs=[dict(temperature=0.7, seed=3),
                              dict(temperature=1.3, seed=4),
                              dict(temperature=0.9), dict(temperature=1.1)])),
}


@pytest.fixture(scope="module")
def jax_models():
    paddle.seed(0)
    jl = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=2))
    jl.eval()
    paddle.seed(0)
    jg = jgpt.GPTForCausalLM(jgpt.GPT_TINY)
    jg.eval()
    return {"llama": jl, "gpt": jg}


@pytest.fixture(scope="module")
def weights(jax_models, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_weights")
    paths = {}
    for arch, jm in jax_models.items():
        paths[arch] = str(d / f"{arch}.npz")
        np.savez(paths[arch], **{k: np.asarray(v._data)
                                 for k, v in jm.state_dict().items()})
    return paths


@pytest.fixture(scope="module")
def port_models(weights):
    return {a: W.tp_model(a, p) for a, p in weights.items()}


@pytest.fixture(scope="module")
def jax_tokens(jax_models):
    """The JAX ``Engine(tp=N)``'s tokens of every job (once per module)."""
    return {name: W.run_workload(
        JaxEngine(jax_models[job["arch"]], tp=job["tp"], **job["engine"]),
        job["workload"]) for name, job in JOBS.items()}


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """Every rank's record of the spawns of 4 and of 2 ranks: {tp: [rank
    0's, rank 1's, ...]}."""
    out = tmp_path_factory.mktemp("tp_runs")
    runs = {}
    for tp in (4, 2):
        spec = dict(weights=weights, jobs={n: j for n, j in JOBS.items()
                                           if j["tp"] == tp})
        if tp == 4:
            sampled = JOBS["llama sampled"]
            spec["adopt"] = dict(
                engine=sampled["engine"],
                prompt=sampled["workload"]["prompts"][0],
                kwargs=dict(sampled["workload"]["common"],
                            max_new_tokens=sampled["workload"]["max_new"]))
        path = out / f"spec{tp}.pkl"
        with open(path, "wb") as f:
            pickle.dump(spec, f)
        dist.spawn(W.serving_tp_worker, args=(str(out), str(path)),
                   nprocs=tp, timeout=300)
        runs[tp] = []
        for r in range(tp):
            with open(out / f"tp{tp}.r{r}.pkl", "rb") as f:
                runs[tp].append(pickle.load(f))
    return runs


def _rank_tokens(port_runs, name):
    """The job's tokens, after checking that every rank emitted them."""
    ranks = port_runs[JOBS[name]["tp"]]
    toks = [rk["jobs"][name]["tokens"] for rk in ranks]
    assert all(t == toks[0] for t in toks), name
    return toks[0]


def _tp1_tokens(port_models, name):
    job = JOBS[name]
    return W.run_workload(Engine(port_models[job["arch"]], **job["engine"]),
                          job["workload"])


# ---------------------------------------------------------------------------
# construction contract
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_tp_validation_raises_the_jax_errors(jax_models, port_models):
    jl, tl = jax_models["llama"], port_models["llama"]
    slot = {k: v for k, v in GEO.items() if k != "block_size"}
    two = mesh.build_mesh(tp=2, world_size=2, rank=0)   # no process group
    cases = {
        "kv_layout": (lambda m, **kw: Engine(m, kv_layout="slot", tp=2,
                                             **slot, **kw),
                      lambda: JaxEngine(jl, kv_layout="slot", tp=2, **slot)),
        "does not divide": (lambda m, **kw: Engine(m, tp=3, **GEO, **kw),
                            lambda: JaxEngine(jl, tp=3, **GEO)),
        "mesh= requires tp > 1": (
            lambda m, **kw: Engine(m, mesh=object(), **GEO),
            lambda: JaxEngine(jl, mesh=object(), **GEO)),
        "mesh tp axis": (
            lambda m, **kw: Engine(m, tp=2, mesh=mesh.build_mesh(
                dp=2, world_size=2, rank=0), **GEO),
            lambda: JaxEngine(jl, tp=2, mesh=jax_mesh.build_mesh(), **GEO)),
        "flash_decode": (
            lambda m, **kw: Engine(m, tp=2, mesh=two, flash_decode=True,
                                   **GEO),
            lambda: JaxEngine(jl, tp=2, flash_decode=True, **GEO)),
    }
    for what, (port, ref) in cases.items():
        got, want = _message(lambda: port(tl)), _message(ref)
        assert what in got and got == want, (what, got, want)
    e = Engine(tl, **GEO)
    assert e.tp == 1 and e.tp_geometry() is None
    assert "mesh" not in e.stats() and e.stats()["tp"] == 1


# ---------------------------------------------------------------------------
# token identity
# ---------------------------------------------------------------------------

def test_tp4_greedy_equals_jax_tp1_and_generate(port_runs, jax_tokens,
                                                port_models):
    got = _rank_tokens(port_runs, "llama greedy")
    assert got == jax_tokens["llama greedy"]
    assert got == _tp1_tokens(port_models, "llama greedy")
    p0 = JOBS["llama greedy"]["workload"]["prompts"][0]
    gen = port_models["llama"].generate(p0[None], max_new_tokens=6)
    assert got[0] == gen[0, len(p0):].tolist()


def test_tp4_sampled_equals_jax_and_tp1(port_runs, jax_tokens, port_models):
    got = _rank_tokens(port_runs, "llama sampled")
    assert got == jax_tokens["llama sampled"]
    assert got == _tp1_tokens(port_models, "llama sampled")


def test_tp4_sampled_adopt_mid_flight_equals_jax(port_runs, jax_tokens):
    """``tests/test_serving_tp.py:97``'s second half: a sampled request
    part-way through its tokens, adopted by a fresh tp-4 engine on every
    rank, finishes with the uninterrupted run's tokens (the key-chain
    fast-forward keeps even sampled replay token-identical)."""
    runs = [rk["adopt"] for rk in port_runs[4]]
    assert all(r == runs[0] for r in runs)
    assert 0 < runs[0]["before"] < 6
    assert runs[0]["tokens"] == jax_tokens["llama sampled"][0]


def test_tp2_chunked_shared_preempted_equals_jax_and_tp1(
        port_runs, jax_tokens, port_models):
    name = "llama chunked shared preempted"
    got = _rank_tokens(port_runs, name)
    assert got == jax_tokens[name]
    assert got == _tp1_tokens(port_models, name)
    for rk in port_runs[2]:
        st = rk["jobs"][name]["stats"]
        assert st["chunk_steps"] > 0 and st["prefix_hit_tokens"] > 0
        assert st["preemptions"] >= 1 and st["chunk_program"]
        assert rk["jobs"][name]["refcounts"]


@pytest.mark.parametrize("name", ["gpt greedy", "gpt sampled chunked"])
def test_gpt_tp2_equals_jax_and_tp1(port_runs, jax_tokens, port_models,
                                    name):
    got = _rank_tokens(port_runs, name)
    assert got == jax_tokens[name]
    assert got == _tp1_tokens(port_models, name)
    st = port_runs[2][0]["jobs"][name]["stats"]
    assert st["prefix_hit_tokens"] > 0
    if "chunked" in name:
        assert st["chunk_steps"] > 0


# ---------------------------------------------------------------------------
# the tp bodies against JAX's
# ---------------------------------------------------------------------------

def _jax_layer(jm, arch, body, tp=2):
    """Layer 0's JAX tp body under ``shard_map`` over a tp mesh of the
    virtual devices, on ``torch_dist_worker.layer_inputs``; its hidden
    state."""
    c = jm.config
    h, nh = c.hidden_size, c.num_attention_heads
    nkv = c.num_key_value_heads if arch == "llama" else nh
    a = W.layer_inputs(h, nkv, h // nh)
    if arch == "llama":
        w, keys = JG._stacked_weights(jm), JG._LLAMA_STACK_KEYS
        specs = JG._llama_tp_specs()
        hp = dict(n_heads=nh, n_kv=nkv, eps=c.rms_norm_eps,
                  theta=c.rope_theta, tp=tp)
    else:
        w, keys = JG._gpt_stacked_weights(jm), JG._GPT_STACK_KEYS
        specs = JG._gpt_tp_specs()
        hp = dict(n_heads=nh, tp=tp)
    lw = {k: w[k][0] for k in keys}
    if arch == "gpt":
        perm = JG._gpt_qkv_tp_permutation(h, tp)
        lw["wqkv"], lw["bqkv"] = lw["wqkv"][..., perm], lw["bqkv"][..., perm]
    lspec = {k: P(*specs[k][1:]) for k in keys}
    R, kv = P(), P(None, None, "tp", None)
    bs = W.LAYER_GEO["bs"]
    if body == "prefill":
        fn = getattr(JG, f"_{arch}_prefill_layer_tp")
        if arch == "llama":
            def f(x, lw, pos):
                return fn(x, lw, pos, **hp)[0]
            args, specs_in = (a["x"], lw, a["pos"]), (R, lspec, R)
        else:
            def f(x, lw):
                return fn(x, lw, **hp)[0]
            args, specs_in = (a["x"], lw), (R, lspec)
    elif body == "decode":
        fn = getattr(JG, f"_{arch}_decode_layer_paged_tp")

        def f(xt, lw, kc, vc, tables, dest, wp):
            rope = (wp,) if arch == "llama" else ()
            return fn(xt, lw, kc, vc, tables, dest, wp, *rope,
                      block_size=bs, **hp)[0]
        args = (a["xt"], lw, a["kc"], a["vc"], a["tables"], a["dest"],
                a["write_pos"])
        specs_in = (R, lspec, kv, kv, R, R, R)
    else:
        fn = getattr(JG, f"_{arch}_chunk_layer_tp")

        def f(x, lw, kc, vc, table_row, gpos, wdest):
            return fn(x, lw, kc, vc, table_row, gpos, wdest, block_size=bs,
                      **hp)[0]
        args = (a["xc"], lw, a["kc"], a["vc"], a["table_row"], a["gpos"],
                a["wdest"])
        specs_in = (R, lspec, kv, kv, R, R, R)
    sm = shard_map(f, mesh=jax_mesh.build_mesh(tp=tp), in_specs=specs_in,
                   out_specs=R, check_rep=False)
    return np.asarray(jax.jit(sm)(*args))


@pytest.mark.parametrize("arch", ["llama", "gpt"])
@pytest.mark.parametrize("body", ["prefill", "decode", "chunk"])
def test_tp_body_matches_the_jax_tp_body(port_runs, jax_models, arch, body):
    want = _jax_layer(jax_models[arch], arch, body)
    got = [rk["layers"][arch][body] for rk in port_runs[2]]
    np.testing.assert_array_equal(got[0], got[1])     # replicated
    rel = np.linalg.norm(got[0] - want) / np.linalg.norm(want)
    assert got[0].shape == want.shape and rel <= REL_TOL, rel


# ---------------------------------------------------------------------------
# one clock decides; the geometry; the submit guard
# ---------------------------------------------------------------------------

def test_a_skewed_rank_clock_cannot_split_the_ranks(port_runs):
    r0, r1 = (rk["skew"] for rk in port_runs[2])
    # rank 1 ahead: rank 0's clock says the deadline has not passed
    assert r0["rank 1 ahead"] == r1["rank 1 ahead"]
    assert r0["rank 1 ahead"][0] == "length"
    assert len(r0["rank 1 ahead"][1]) == 8
    # rank 0 ahead: both ranks time out at the same step
    assert r0["rank 0 ahead"] == r1["rank 0 ahead"]
    reason, toks = r0["rank 0 ahead"]
    assert reason == "timeout" and 0 < len(toks) < 8


def test_stats_mesh_and_the_collectives_of_a_decode_step(port_runs):
    n_layers, n_kv = 2, 4
    for tp, name in ((4, "llama greedy"), (2, "llama chunked shared "
                                               "preempted")):
        for r, rk in enumerate(port_runs[tp]):
            st = rk["jobs"][name]["stats"]
            m = st["mesh"]
            assert st["tp"] == m["tp"] == tp
            assert m["ranks"] == list(range(tp)) and m["device"] == "cpu"
            assert m["kv_heads_per_device"] == n_kv // tp
            assert m["kv_pool_bytes_per_device"] * tp == st["kv_cache_bytes"]
            assert m["collectives_per_decode_step"] == 2 * n_layers + 1
            snap = rk["jobs"][name]["snapshot"]
            assert snap["tp"] == tp and snap["collectives_per_decode_step"] \
                == m["collectives_per_decode_step"]
    for rk in port_runs[2]:
        assert rk["step_collectives"] == {"all_reduce": 2 * n_layers,
                                          "all_gather": 1}
        assert sum(rk["step_collectives"].values()) == \
            rk["step_geometry"]["collectives_per_decode_step"]


def test_submit_guard_raises_on_every_rank_when_ranks_disagree(port_runs):
    for rk in port_runs[2]:
        assert "disagree" in rk["guard"], rk["guard"]
    assert port_runs[2][0]["after_guard"] == port_runs[2][1]["after_guard"]
    assert len(port_runs[2][0]["after_guard"]) == 4 + 2


def test_tp_placement_specs_are_the_jax_specs_per_layer():
    from paddle_tpu_torch.text import generation as G
    for ours, theirs in ((G._llama_tp_specs(), JG._llama_tp_specs()),
                         (G._gpt_tp_specs(), JG._gpt_tp_specs())):
        assert ours.keys() == theirs.keys()
        for k, spec in ours.items():
            want = tuple(theirs[k])
            stacked = k in JG._LLAMA_STACK_KEYS + JG._GPT_STACK_KEYS
            assert spec == (want[1:] if stacked else want), k
    for h, tp in ((128, 2), (256, 4), (768, 3)):
        np.testing.assert_array_equal(G._gpt_qkv_tp_permutation(h, tp),
                                      JG._gpt_qkv_tp_permutation(h, tp))
