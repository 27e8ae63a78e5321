"""Serving robustness of the PyTorch port under tensor parallelism:
``Engine.adopt`` at tp > 1, ``EngineSupervisor(tp=N)`` and the mixed-tp
``ReplicaFleet``, against the JAX package.

The tiny fp32 Llama (LLAMA_TINY cut to 2 layers, as
``tests/test_serving_tp.py``'s) is built in the JAX package and carried
into the port through numpy. One module-scoped spawn of two gloo ranks on
the CPU (``torch_dist_worker.serving_tp_resilience_worker``) runs every
case in the SPMD way, and each rank writes what it saw; the JAX engines
and the port's tp-1 engine run here.

- the tp2 supervisor's token-identical rebuild through ``decode-raise``
  (``tests/test_serving_tp.py:153``): every rank's tokens equal the
  uninterrupted ``Engine(tp=2)``'s, the JAX engine's and the port's tp-1
  engine's; one rebuild, ``sup.engine.tp == 2``, and the counters and the
  ledger records (wall-clock stamps aside) equal on both ranks;
- a fault confined to rank 1 (``ChaosMonkey(ranks=)``): a raise, a stall
  inside its decode step past ``step_timeout_s``, a KV corruption of its
  shard; and rank 1 wedging past its timeout after the last collective
  of the step that finishes a request (``stall_inside(late=True)``), so
  that rank 0 has emitted the step's tokens before the verdict; each
  gives one rebuild of both ranks at the same supervised step and the
  same tokens, streamed once each, with no hang (the spawn's timeout
  would fail the test);
- the mixed-tp fleet's migration (``tests/test_serving_fleet.py:490``):
  r0 at tp 2 and r1 at tp 1 on both ranks, r0 then r1 killed mid-decode,
  ``migrations >= 2``, tokens equal to the JAX engine's and the port's
  tp-1 engine's on the same schedule;
- routing equal on both ranks while rank 1's clock runs 10^4 s ahead and
  its r0 reports a slow rolling ITL (rank 0's clock decides);
- the adopt guard raising on every rank when the ranks' handles differ.

``tests/test_torch_serving_tp.py``'s 4-rank spawn holds the tp-4 sampled
``adopt`` (``tests/test_serving_tp.py:97``).
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.resilience import ChaosMonkey
from paddle_tpu_torch.serving import Engine, EngineSupervisor, ReplicaFleet

SUPERVISED = ["decode-raise", "rank 1 raise", "rank 1 stall",
              "rank 1 kv-corrupt", "rank 1 late stall"]
KIND = {"decode-raise": "step_errors", "rank 1 raise": "step_errors",
        "rank 1 stall": "wedges", "rank 1 kv-corrupt": "kv_corruptions",
        "rank 1 late stall": "wedges"}
GEN = dict(max_new_tokens=6, seed=11)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                      num_hidden_layers=2))
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def weights(jax_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("tpr_weights") / "llama.npz"
    np.savez(path, **{k: np.asarray(v._data)
                      for k, v in jax_model.state_dict().items()})
    return str(path)


@pytest.fixture(scope="module")
def port_model(weights):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield W.tp_model("llama", weights)
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Both ranks' records of the one spawn."""
    out = tmp_path_factory.mktemp("tpr_runs")
    dist.spawn(W.serving_tp_resilience_worker, args=(str(out), weights),
               nprocs=2, timeout=240)
    recs = []
    for r in range(2):
        with open(out / f"tpr.r{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs


@pytest.fixture(scope="module")
def references(jax_model, port_model):
    """The JAX engine's and the port's tp-1 engine's tokens of the
    supervised workload and of the mixed-tp fleet's schedule."""
    shared = W.tpr_shared()
    prompts = W.tpr_prompts([3, 4, 5, 6], seed=14, shared_prefix=8)
    out = {}
    for name, eng_cls, model in (("jax", JaxEngine, jax_model),
                                 ("tp1", Engine, port_model)):
        sup = eng_cls(model, **W.TPR_CHUNKED)
        hs = [sup.submit(p, **GEN) for p in shared[:2]]
        sup.drain()
        fleet = W.tpr_mixed_fleet(eng_cls(model, **W.TPR_SAMPLED), prompts)
        out[name] = dict(supervised=[[int(t) for t in h.tokens]
                                     for h in hs],
                         fleet=[[int(t) for t in h.tokens] for h in fleet])
    return out


def _same(ranks, key):
    assert ranks[0][key] == ranks[1][key], key
    return ranks[0][key]


@pytest.mark.parametrize("case", SUPERVISED)
def test_tp2_supervisor_rebuild_token_identical(ranks, references, case):
    rec = _same(ranks, case)
    want = _same(ranks, "uninterrupted")
    assert rec["tokens"] == want
    # on_token streamed every token once, the replayed ones included
    assert rec["streamed"] == want
    assert want == references["jax"]["supervised"]
    assert want == references["tp1"]["supervised"]
    assert rec["rebuilds"] == 1 and rec["tp"] == 2
    assert rec["counters"][KIND[case]] == 1
    assert rec["replayed"] >= 1
    # one trace id a request, rank 0's, on both ranks
    assert len(set(rec["trace_ids"])) == len(rec["trace_ids"])


@pytest.mark.parametrize("case", SUPERVISED)
def test_one_group_rebuild_at_one_step_equal_ledgers(ranks, case):
    r0, r1 = (rk[case]["records"] for rk in ranks)
    assert r0 == r1
    events = [r["event"] for r in r0]
    assert events.count("rebuild") == 1 and events.count("anomaly") == 1
    anomaly = next(r for r in r0 if r["event"] == "anomaly")
    if case == "rank 1 raise":
        # the raise was rank 1's alone; rank 0 followed the group
        assert anomaly["error"].startswith("rank 1: ChaosError")
        assert "rank 0" not in anomaly["error"]
    if case in ("rank 1 stall", "rank 1 late stall"):
        assert anomaly["kind"] == "wedge"
    if case == "rank 1 late stall":
        # rank 0's step completed: the timeout was rank 1's alone
        assert anomaly["error"].startswith("rank 1: StepTimeout")
        assert "rank 0" not in anomaly["error"]
    rebuild = next(r for r in r0 if r["event"] == "rebuild")
    assert rebuild["n_active"] >= 1


def test_mixed_tp_fleet_migration_parity(ranks, references):
    rec = _same(ranks, "fleet")
    assert rec["tps"] == {"r0": 2, "r1": 1}
    assert rec["tokens"] == references["jax"]["fleet"]
    assert rec["tokens"] == references["tp1"]["fleet"]
    assert rec["migrations"] >= 2
    assert rec["reasons"] == ["length"] * 4
    assert rec["refcounts"]


def test_routing_follows_rank0_under_a_skewed_clock(ranks):
    rec = _same(ranks, "skew")
    # rank 1 alone would have routed every request away from its "slow"
    # r0; rank 0's load put the first request there
    assert rec["replicas"][0] == "r0"
    assert set(rec["replicas"]) == {"r0", "r1"}
    assert all(len(t) == 4 for t in rec["tokens"])


def test_adopt_guard_raises_on_every_rank(ranks):
    for rk in ranks:
        assert "disagree on adopt" in rk["adopt_guard"], rk["adopt_guard"]


def test_the_tp_refusals_are_gone_and_tp_validation(port_model):
    from paddle_tpu_torch.distributed import mesh

    # a replica of tp 3 in a world of one: neither one rank nor all
    with pytest.raises(ValueError, match="a replica spans one rank"):
        ReplicaFleet(port_model, 2, tp_degrees=[3, 1], **W.TPR_GEO)
    with pytest.raises(ValueError, match="ranks= confines"):
        ChaosMonkey(at={2: "abandon"}, ranks={2: 1})
    with pytest.raises(ValueError, match="_group= requires tp > 1"):
        Engine(port_model, _group=mesh.build_mesh(
            tp=2, world_size=2, rank=0), **W.TPR_GEO)
    # a confined stall is found by the step timeout only
    sup = EngineSupervisor(port_model, chaos=ChaosMonkey(
        at={0: "decode-stall"}, ranks={0: 0}), **W.TPR_GEO)
    sup.submit(np.arange(5), max_new_tokens=2)
    with pytest.raises(ValueError, match="step_timeout_s"):
        sup.step()

