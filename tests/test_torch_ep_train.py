"""Expert-parallel ERNIE-MoE training (``mp_degree`` > 1) on the port
against the JAX package's single-device step, and the model-parallel RNG
tracker against the JAX one.

The JAX side: ``ERNIE_MOE_TINY`` (4 experts, fp32, dropout 0), its MoE
layers on sparse dispatch with the ragged expert kernel (Pallas in
interpret mode, as ``tests/test_torch_ernie_moe.py`` runs it) and, for
the dense configuration, on dense dispatch; AdamW lr 1e-3, 3 steps on
one 4 x 32 batch. Its initial weights reach every rank through
``load_numpy_state_dict``. Every configuration of
``torch_dist_worker.EP_CONFIGS`` trains in one module-scoped spawn of 4
gloo ranks on the CPU:

- mp2, mp4 (one expert a rank), dp2 x mp2 and dp4 (each dp rank
  routes its share of the batch as the JAX layer routes the whole:
  capacity, queue places and the load-balance loss over the global
  batch) and the dense dispatch at mp2: losses within rtol 2e-4, the JAX
  package's own expert-parallel bound
  (``tests/test_expert_parallel.py:63``), and the parameters after
  ``gather_state_dict`` by ``tests/test_torch_hybrid_train.py``'s rule;
  rank r holds block r of each ``[E, ...]`` bank, and the ragged matmul
  ran on ``[E/tp, C, d]`` expert inputs;
- mp3 warns with the JAX package's text, keeps the experts whole and
  still matches;
- dropout 0.1 at mp2 gives the losses of the port's own single-rank step
  at the same seed (rtol 2e-4): the tp ranks drew the same masks;
- two planted faults (``chip_smoke.EP_FAULTS``: the expert input's dx
  not all-reduced over tp; ``reduce_from_tp``'s backward summing over
  tp) fail the loss/parameter check.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dist_worker as W
from jax.sharding import PartitionSpec as P
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.distributed.fleet import meta_parallel as jax_mp
from paddle_tpu.distributed.fleet.train_step import _opt_state_pspec
from paddle_tpu.framework import random_seed as jax_random_seed
from paddle_tpu.text.models.ernie_moe import ERNIE_MOE_TINY as JAX_TINY
from paddle_tpu.text.models.ernie_moe import \
    ErnieMoEForPretraining as JaxErnie
import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.framework import random_seed
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY,
                                          ErnieMoEForPretraining)

WORLD = 4
E = ERNIE_MOE_TINY.num_experts
MP3_WARNING = (f"MoE num_experts={E} not divisible by mp_degree=3; experts "
               "stay replicated (no EP)")


def _batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, ERNIE_MOE_TINY.vocab_size, (4, 32)),
            rng.integers(0, ERNIE_MOE_TINY.vocab_size, (4, 32)))


def _arrays(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _jax_run(dispatch):
    """(initial weights, losses, final weights) of the JAX single-device
    step with the MoE layers on ``dispatch``."""
    jax_mesh.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        model = JaxErnie(dataclasses.replace(JAX_TINY, dropout=0.0))
        for m in [b.moe for b in model.ernie.blocks if b.use_moe]:
            m.dispatch_mode = dispatch
            m.expert_kernel = "ragged" if dispatch == "sparse" else "einsum"
        model = jax_fleet.distributed_model(model)
        init = _arrays(model)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
        ids, labels = (paddle.to_tensor(a.astype(np.int32))
                       for a in _batch())
        losses = [float(step(ids, labels).numpy()) for _ in range(W.STEPS)]
        return init, losses, _arrays(model)
    finally:
        jax_mesh.set_mesh(None)


@pytest.fixture(scope="module")
def jax_runs():
    return {d: _jax_run(d) for d in ("sparse", "dense")}


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ep")
    np.savez(out / "init.npz", **jax_runs["sparse"][0])
    ids, labels = _batch()
    np.savez(out / "batch.npz", ids=ids, labels=labels)
    dist.spawn(W.ep_worker, args=(str(out), str(out / "init.npz"),
                                  str(out / "batch.npz"),
                                  list(W.EP_CONFIGS)),
               nprocs=WORLD, timeout=600)
    runs = {}
    for name in W.EP_CONFIGS:
        with open(out / f"{name}.pkl", "rb") as f:
            runs[name] = pickle.load(f)
        runs[name]["ranks"] = {}
        for r in range(WORLD):
            p = out / f"{name}.r{r}.pkl"
            if p.exists():
                with open(p, "rb") as f:
                    runs[name]["ranks"][r] = pickle.load(f)
    return runs


def _params_close(got, want):
    """``tests/test_torch_hybrid_train.py``'s rule: every element within
    6 lr, at most 0.1% of them beyond 1e-5 (Adam's first update is lr *
    sign(g): a rounding-level gradient whose sign flips moves an element
    by up to 2 lr a step)."""
    if got.keys() != want.keys():
        return False
    n = far = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        if diff.max() > 6 * W.LR:
            return False
        far += int((diff > 1e-5).sum())
        n += diff.size
    return far <= 1e-3 * n


def _matches(run, want_losses, want_final):
    return (np.allclose(run["losses"], want_losses, rtol=2e-4, atol=0)
            and _params_close(run["params"], want_final))


def _want(name):
    return "dense" if W.EP_CONFIGS[name].get("dispatch") == "dense" \
        else "sparse"


@pytest.mark.parametrize("name", ["mp2", "mp4", "dp2_mp2", "dp4",
                                  "mp2_dense", "mp3"])
def test_ep_step_matches_the_jax_single_device_step(jax_runs, port_runs,
                                                   name):
    _, want_losses, want_final = jax_runs[_want(name)]
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=2e-4)
    assert run["losses"][2] < run["losses"][0]
    assert _params_close(run["params"], want_final)
    for r, rk in run["ranks"].items():      # every rank the global loss
        assert rk["losses"] == run["losses"], r


@pytest.mark.parametrize("name", ["mp2", "mp4", "dp2_mp2", "mp2_dense"])
def test_each_rank_holds_and_runs_its_block_of_experts(port_runs, name):
    c = W.EP_CONFIGS[name]
    tp = c["mp"]
    full = port_runs[name]["params"]
    d, f = ERNIE_MOE_TINY.hidden_size, ERNIE_MOE_TINY.intermediate_size
    assert sorted(port_runs[name]["ranks"]) == list(range(c.get("dp", 1)
                                                          * tp))
    for r, rk in port_runs[name]["ranks"].items():
        for k, shape in rk["banks"].items():
            assert shape == (E // tp,) + full[k].shape[1:], (r, k)
        want_ranks = [r - r % tp + i for i in range(tp)]
        assert rk["ep_ranks"] == [want_ranks] * len(rk["ep_ranks"]), r
        if c.get("dispatch") == "dense":
            assert rk["ragged_shapes"] == [], r
        else:
            # the expert inputs of the up and down products: [E/tp, C, d]
            # and [E/tp, C, f]; C from the global batch's 128 tokens (80
            # at k 2, as the JAX layer's), under dp too
            C = -(-2 * 4 * 32 * 5 // (4 * E))
            assert rk["ragged_shapes"] == sorted(
                [(E // tp, C, d), (E // tp, C, f)]), r


def test_mp3_warns_keeps_the_experts_whole_and_matches(port_runs):
    for r, rk in port_runs["mp3"]["ranks"].items():
        assert MP3_WARNING in rk["warnings"], r
        assert all(s[0] == E for s in rk["banks"].values()), r
        assert rk["ep_ranks"] == [None] * len(rk["ep_ranks"]), r
    assert sorted(port_runs["mp3"]["ranks"]) == [0, 1, 2]


def test_dropout_masks_agree_across_tp_ranks(port_runs):
    """Dropout 0.1 at mp2 trains as the port's single-rank step at the
    same seed: both tp ranks drew the single-rank masks."""
    want = port_runs["world1_dropout"]["losses"]
    np.testing.assert_allclose(port_runs["mp2_dropout"]["losses"], want,
                               rtol=2e-4)
    # and dropout is really on: the losses differ from the dropout-0 run
    assert not np.allclose(want, port_runs["mp2"]["losses"], rtol=1e-3)


@pytest.mark.parametrize("fault", [n for n, c in W.EP_CONFIGS.items()
                                   if "fault" in c])
def test_planted_faults_fail_the_check(jax_runs, port_runs, fault):
    _, want_losses, want_final = jax_runs["sparse"]
    assert not _matches(port_runs[fault], want_losses, want_final)
    assert _matches(port_runs["mp2"], want_losses, want_final)


def test_model_parallel_random_seed_seeds_per_mp_rank(port_runs):
    """JAX's arithmetic: the tracker's stream at seed * 1024 + mp_rank *
    100, the framework's generators at seed."""
    for name in ("mp2", "dp2_mp2", "mp4"):
        tp = W.EP_CONFIGS[name]["mp"]
        for r, rk in port_runs[name]["ranks"].items():
            assert rk["tracker_seeds"] == [1234 * 1024 + (r % tp) * 100]
            assert rk["global_seed"] == 1234


# -- placement ---------------------------------------------------------------

def test_expert_banks_carry_the_jax_annotation_and_placement():
    jax_mesh.set_mesh(None)
    paddle.seed(0)
    jm = JaxErnie(JAX_TINY)
    want = {k: (tuple(p.pspec) if p.pspec is not None else None)
            for k, p in jm.named_parameters()}
    mesh.set_mesh(None)
    got = {k: getattr(p, "pspec", None) for k, p in ErnieMoEForPretraining(
        ERNIE_MOE_TINY, device="cpu").named_parameters()}
    assert got == want
    assert got["ernie.blocks.1.moe.w_up"] == ("tp", None, None)
    shape = (E, ERNIE_MOE_TINY.hidden_size, ERNIE_MOE_TINY.intermediate_size)
    for dp, sharding, tp in ((1, 1, 2), (2, 1, 2), (1, 2, 2), (1, 4, 2)):
        jax_mesh.set_mesh(jax_mesh.build_mesh(dp=dp, tp=tp,
                                              sharding=sharding))
        m = mesh.build_mesh(dp=dp, tp=tp, sharding=sharding, world_size=8,
                            rank=0)
        try:
            for stage in (1, 2, 3):
                jspec = jax_mesh.infer_param_pspec(shape, P("tp", None, None),
                                                   stage)
                pspec = mesh.infer_param_pspec(shape, ("tp", None, None),
                                               stage, mesh=m)
                assert pspec == tuple(jspec) == ("tp", None, None)
                assert mesh.opt_state_pspec(pspec, shape, shape, stage,
                                            mesh=m) == tuple(
                    _opt_state_pspec(jspec, shape, shape, stage))
        finally:
            jax_mesh.set_mesh(None)


def test_ernie_accepts_any_tp_degree():
    model = ErnieMoEForPretraining(ERNIE_MOE_TINY, device="cpu")
    for tp in (2, 3, 4):
        assert model.check_tensor_parallel(tp) is None


# -- the RNG tracker ----------------------------------------------------------

def _draw(n=4):
    return F.dropout(torch.ones(n), p=0.5).numpy()


@pytest.fixture
def on_cpu(monkeypatch):
    """The framework's device set to the CPU (the tracker's streams live
    there) for one test."""
    monkeypatch.setattr(device_mod, "_current_device", "cpu")


def test_rng_tracker_api_matches_jax(on_cpu):
    for Tracker in (mp.RNGStatesTracker, jax_mp.RNGStatesTracker):
        tracker = Tracker()
        tracker.add("mp_rng", 123)
        with pytest.raises(ValueError, match="already exists"):
            tracker.add("mp_rng", 99)
        with pytest.raises(ValueError, match="already exists"):
            tracker.add("other", 123)
        with pytest.raises(ValueError, match="does not exist"):
            with tracker.rng_state("nope"):
                pass
        assert set(tracker.get_states_tracker()) == {"mp_rng"}
        tracker.reset()
        assert tracker.get_states_tracker() == {}
    assert mp.get_rng_state_tracker() is mp.get_rng_state_tracker()
    assert isinstance(mp.get_rng_state_tracker(), mp.RNGStatesTracker)


def test_rng_state_swaps_the_framework_generator_for_the_block(on_cpu):
    tracker = mp.RNGStatesTracker()
    tracker.add("mp_rng", 123)
    pt.seed(7)
    a = _draw(64)
    pt.seed(7)
    with tracker.rng_state("mp_rng"):
        b1 = _draw(64)                  # from the tracked stream
    c = _draw(64)                       # the framework's stream resumes
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b1)
    with tracker.rng_state("mp_rng"):   # the tracked stream advanced
        b_next = _draw(64)
    assert not np.array_equal(b1, b_next)
    tracker2 = mp.RNGStatesTracker()
    tracker2.add("mp_rng", 123)
    with tracker2.rng_state("mp_rng"):
        np.testing.assert_array_equal(_draw(64), b1)   # same seed
    # the states carry across trackers
    tracker3 = mp.RNGStatesTracker()
    tracker3.set_states_tracker(tracker2.get_states_tracker())
    with tracker3.rng_state("mp_rng"):
        np.testing.assert_array_equal(_draw(64), b_next)


def test_model_parallel_random_seed_matches_jax_at_world1(on_cpu):
    jax_mesh.set_mesh(None)
    mesh.set_mesh(None)
    try:
        jax_fleet.init(is_collective=True,
                       strategy=jax_fleet.DistributedStrategy())
        jax_mp.model_parallel_random_seed(5)
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
        mp.model_parallel_random_seed(5)
        assert mp.get_rng_state_tracker().seeds_ == \
            jax_mp.get_rng_state_tracker().seeds_ == {5 * 1024}
        assert random_seed._seed_value == jax_random_seed.get_seed() == 5
        assert set(mp.get_rng_state_tracker().get_states_tracker()) == \
            {"model_parallel_rng"}
    finally:
        jax_mesh.set_mesh(None)
        mesh.set_mesh(None)
        mp.get_rng_state_tracker().reset()
        jax_mp.get_rng_state_tracker().reset()
