"""The port's comm-efficient data-parallel steps (``fleet/comm_efficient.
py``: LocalSGD, Geo-SGD, DGC, the compressed all-reduce) against the JAX
package's, and the routing of every comm-efficient strategy.

The JAX side runs ``paddle_tpu.distributed.fleet.comm_efficient``'s steps
on the 8-virtual-device mesh, one module-scoped fixture; the port side
every other configuration of ``torch_dist_worker.COMM_CONFIGS`` in one
module-scoped spawn of 4 gloo ranks on the CPU, from the JAX model's
initial weights: fp32 ``LLAMA_TINY`` on one 8 x 32 batch, 3 steps;
``fp16_allreduce`` bfloat16 and int8 at dp 4 (AdamW lr 1e-3); LocalSGD
k 1 at dp 2 (SGD lr 5e-2) and k 2 with ``begin_step`` 1 at dp 4; Geo
(``a_sync``) k 2 at dp 4; DGC 0.99 at dp 2 with Momentum 0.9 lr 1e-3,
with and without ``clip_norm``.

- Losses within rtol 2e-4 (the JAX package's hybrid bound) and the
  parameters by ``tests/test_torch_train_step.py``'s rule; for LocalSGD
  and Geo every replica's (JAX's ``[dp, ...]``), for the others the
  replicated ones, equal on every rank.
- LocalSGD k 1 is the port's plain dp ``TrainStep`` under SGD; its
  replicas are equal right after an averaging step and apart between;
  Geo's ``replica_divergence()`` is 0 right after a merge.
- DGC's top-k: ``jax.lax.top_k`` and ``torch.topk`` may order tied values
  differently, so the worker checks on every rank and step that the k-th
  largest ``|v|`` is strictly above the (k+1)-th: no tie decides which
  entries travel, and both send the same set.
- Planted faults (``chip_smoke.COMM_FAULTS``: DGC's sent entries not
  cleared; the Geo merge taken as a mean) fail the judge.
"""
import numpy as np
import pytest

import torch_dist_worker as W
from test_torch_comm_opt import _jax_key, _tiny, judge, run_both
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import comm_opt, fleet
from paddle_tpu_torch.distributed.fleet import comm_efficient as ce

NAMES = [n for n in W.COMM_CONFIGS if not n.startswith("co_")]
CLEAN = [n for n in NAMES if "fault" not in W.COMM_CONFIGS[n]
         and W.COMM_CONFIGS[n]["mode"] != "trainstep"]
FAULTS = [n for n in NAMES if "fault" in W.COMM_CONFIGS[n]]
KIND = {"fp16_allreduce": "CompressedAllreduceTrainStep",
        "localsgd": "LocalSGDTrainStep", "a_sync": "GeoSGDTrainStep",
        "dgc": "DGCTrainStep"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(NAMES, CLEAN, tmp_path_factory.mktemp("comm_efficient"))


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[1]


@pytest.mark.parametrize("name", CLEAN)
def test_step_matches_the_jax_step(jax_runs, port_runs, name):
    c, run = W.COMM_CONFIGS[name], port_runs[name]
    assert run["ranks"][0]["kind"] == KIND[c["mode"]]
    judge(run, jax_runs[name], c)
    if c["mode"] not in ("localsgd", "a_sync"):
        # one replicated model: the same parameters on every rank
        prints = {rk["fingerprint"] for rk in run["ranks"].values()}
        assert len(prints) == 1, prints


def test_localsgd_k1_is_the_plain_dp_step(port_runs):
    lsgd, plain = port_runs["lsgd_dp2_k1"], port_runs["trainstep_dp2"]
    np.testing.assert_allclose(lsgd["losses"], plain["losses"], rtol=1e-6)
    for k, v in plain["params"].items():
        for r in range(2):
            np.testing.assert_allclose(lsgd["params"][k][r], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} replica {r}")


def test_localsgd_replicas_meet_at_each_average(port_runs):
    """k 2, begin_step 1: steps 1 (up to begin_step) and 2 average, step
    3 stays local."""
    for r, rk in port_runs["lsgd_dp4_k2"]["ranks"].items():
        assert rk["spread"][:2] == [0.0, 0.0], r
        assert rk["spread"][2] > 0, r
        assert rk["syncs"] == 2, r
    assert port_runs["lsgd_dp2_k1"]["ranks"][0]["syncs"] == W.STEPS


def test_geo_replicas_meet_at_each_merge(port_runs):
    for r, rk in port_runs["geo_dp4_k2"]["ranks"].items():
        assert rk["spread"][1] == 0.0, r
        assert rk["spread"][0] > 0 and rk["spread"][2] > 0, r
        assert rk["syncs"] == 1, r


@pytest.mark.parametrize("name", ["dgc_dp2", "dgc_dp2_clip"])
def test_dgc_top_k_has_no_tie_at_its_edge(port_runs, name):
    for r, rk in port_runs[name]["ranks"].items():
        assert len(rk["tie_gaps"]) == W.STEPS, r
        assert min(rk["tie_gaps"]) > 0, (r, rk["tie_gaps"])


@pytest.mark.parametrize("name", FAULTS)
def test_planted_fault_fails_the_judge(jax_runs, port_runs, name):
    c = W.COMM_CONFIGS[name]
    twin = next(n for n in CLEAN if _jax_key(n) == _jax_key(name))
    with pytest.raises(AssertionError):
        judge(port_runs[name], jax_runs[twin], c)


# -- routing and refusals ---------------------------------------------------

def _make(field, cfg=None, opt=None, **kw):
    model = _tiny()
    s = fleet.DistributedStrategy()
    setattr(s, field, True)
    getattr(s, field + "_configs").update(cfg or {})
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    o = (opt or optimizer.AdamW)(parameters=model.parameters())
    return fleet.distributed_optimizer(o, s).make_train_step(
        model, lambda m, x, y: m(x, labels=y), **kw)


@pytest.mark.parametrize("field,cfg,opt,cls", [
    ("comm_opt", {}, None, comm_opt.CommOptTrainStep),
    ("a_sync", {"k_steps": 2}, None, ce.GeoSGDTrainStep),
    ("localsgd", {}, None, ce.LocalSGDTrainStep),
    ("dgc", {}, optimizer.Momentum, ce.DGCTrainStep),
    ("dgc", {}, optimizer.SGD, ce.DGCTrainStep),
    ("fp16_allreduce", {}, None, ce.CompressedAllreduceTrainStep),
])
def test_strategy_routes_to_its_step(field, cfg, opt, cls):
    step = _make(field, cfg, opt)
    assert type(step) is cls
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    assert np.isfinite(float(step(ids, ids)))


def test_jax_defaults():
    s = _make("localsgd")
    assert (s.k_steps, s.begin_step) == (4, 1)
    d = _make("dgc", opt=optimizer.Momentum)
    assert (d.momentum, d.clip_norm) == (0.9, None)
    assert d.k == max(1, round(d._N * 0.01))
    assert _make("dgc", opt=optimizer.SGD).momentum == 0.0
    assert _make("fp16_allreduce").dtype == "bfloat16"
    c = _make("comm_opt")
    assert (c.grad_compress, c.zero1, c.tp_overlap, c.qblock) == \
        (None, False, True, 1024)


def _train(**fields):
    """make_train_step with SGD under a strategy of ``fields``."""
    s = fleet.DistributedStrategy()
    for k, v in fields.items():
        setattr(s, k, v)
    model = _tiny()
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    return fleet.distributed_optimizer(optimizer.SGD(
        parameters=model.parameters()), s).make_train_step(
        model, lambda m, x, y: m(x, labels=y))


@pytest.mark.parametrize("case,exc,match", [
    ("geo_k0", NotImplementedError, "pure-async PS mode"),
    ("dgc_adamw", TypeError, "DGC requires SGD/Momentum, got AdamW"),
    ("fp16_dtype", ValueError, "unsupported compression dtype"),
    ("two_strategies", NotImplementedError, "mutually exclusive"),
    ("amp", NotImplementedError, "amp is not supported together"),
    ("options", NotImplementedError, "not supported by the localsgd"),
    ("lamb", NotImplementedError, "item 9"),
])
def test_refusals_raise_as_jax_does(case, exc, match):
    with pytest.raises(exc, match=match):
        if case == "geo_k0":
            _make("a_sync")                 # JAX's default k_steps is 0
        elif case == "dgc_adamw":
            _make("dgc")
        elif case == "fp16_dtype":
            _make("fp16_allreduce", {"dtype": "float16"})
        elif case == "two_strategies":
            _train(localsgd=True, dgc=True)
        elif case == "amp":
            _train(fp16_allreduce=True, amp=True)
        elif case == "options":
            _make("localsgd", accumulate_steps=2)
        else:
            _train(localsgd=True, lamb=True)


def test_whole_placement_keeps_tp_annotated_llama_whole():
    """Under a comm-efficient strategy ``distributed_model`` splits
    nothing: a tp-annotated Llama stays whole (the JAX step keeps it
    replicated over tp)."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet.placement import place_model
    model = _tiny()
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    m = mesh.build_mesh(dp=2, tp=2, world_size=4, rank=0)
    place_model(model, m, 0, whole=True)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    assert all(not any(p.placement) for p in model.parameters())
    with pytest.raises(RuntimeError, match="already placed otherwise"):
        place_model(model, m, 0)
