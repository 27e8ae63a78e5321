"""The port's hybrid-parallel train step against the JAX package's
single-device one.

The JAX side is ``tests/test_torch_train_step.py``'s run: fp32
``LLAMA_TINY`` (2 layers), AdamW lr 1e-3, 3 steps, here on one 8 x 32
batch so that every (dp, sharding) split divides it; further JAX runs
with the fused head (``fused_ce_chunk=256``) and with the tied head. Its initial weights go to
every rank through ``load_numpy_state_dict`` (each rank takes its block).
Every configuration of ``torch_dist_worker.HYBRID_CONFIGS`` (dp4;
sharding4 at stages 1, 2, 3; tp2; tp2 with the fused head; tp2 with
the tied head; tp2 x
sharding2 stage 3; dp2 x sharding2 x tp2 stage 3; stage 3 with full and
selective remat and with accumulate_steps=2; ``group_sharded_parallel("p_g_os")`` on all 8
ranks) trains in one module-scoped spawn of 8 gloo ranks on the CPU.

- Losses within rtol 2e-4, the bound of the JAX package's own hybrid
  tests (``tests/test_distributed.py:62``);
- the parameters after 3 steps, gathered by ``gather_state_dict``, by
  ``tests/test_torch_train_step.py``'s rule (within 1e-5 except where a
  gradient is at rounding-noise level: at most 0.1% of the elements, none
  by more than 6 lr);
- ``ClipGradByGlobalNorm.global_norm`` over every rank's blocks of a set
  of gradients is the norm of the full ones;
- each rank's ``state_dict()`` loaded back replays a step exactly, and
  ``save_group_sharded_model`` writes the gathered weights;
- every rank's parameter and optimizer-state blocks have the shapes the
  placement rules give (``infer_param_pspec`` and ``opt_state_pspec``), and at stage 3 over 4 ranks a rank holds a
  quarter of the bytes of each parameter of at least 1024 elements and
  of its optimizer state.

Also the strategy surface: what the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item, each comm-efficient
strategy refuses what the JAX step refuses, and a tp degree that does
not divide the KV heads a ``ValueError``.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.distributed.fleet.placement import place_model
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

WORLD = 8


def _batch():
    return np.random.default_rng(123).integers(
        0, LLAMA_TINY.vocab_size, (8, 32)).astype(np.int64)


def _jax_run(**cfg_kw):
    """(initial weights, losses, final weights) of the JAX single-device
    train step."""
    jax_mesh.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        cfg = dataclasses.replace(JAX_TINY, dtype="float32", **cfg_kw)
        model = jax_fleet.distributed_model(JaxLlama(cfg))
        init = {k: np.asarray(v._data)
                for k, v in model.state_dict().items()}
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model,
                                   lambda m, ids, lbl: m(ids, labels=lbl))
        ids = paddle.to_tensor(_batch().astype(np.int32))
        losses = [float(step(ids, ids).numpy()) for _ in range(W.STEPS)]
        final = {k: np.asarray(v._data)
                 for k, v in model.state_dict().items()}
    finally:
        jax_mesh.set_mesh(None)
    return init, losses, final


def _jax_key(name):
    """The JAX model options of a configuration (remat changes no
    number)."""
    c = W.HYBRID_CONFIGS[name]
    return tuple((k, c[k]) for k in ("fused_ce_chunk", "tie_word_embeddings")
                 if k in c)


@pytest.fixture(scope="module")
def jax_runs():
    return {key: _jax_run(**dict(key))
            for key in sorted({_jax_key(n) for n in W.HYBRID_CONFIGS})}


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid")
    inits = {}
    for i, (key, run) in enumerate(sorted(jax_runs.items())):
        np.savez(out / f"init{i}.npz", **run[0])
        inits.update({n: str(out / f"init{i}.npz") for n in W.HYBRID_CONFIGS
                      if _jax_key(n) == key})
    np.save(out / "ids.npy", _batch())
    dist.spawn(W.hybrid_worker,
               args=(str(out), inits, str(out / "ids.npy"),
                     list(W.HYBRID_CONFIGS)),
               nprocs=WORLD, timeout=600)
    runs = {}
    for name in W.HYBRID_CONFIGS:
        with open(out / f"{name}.pkl", "rb") as f:
            runs[name] = pickle.load(f)
        runs[name]["dir"] = out
        runs[name]["ranks"] = {}
        for r in range(WORLD):
            p = out / f"{name}.r{r}.pkl"
            if p.exists():
                with open(p, "rb") as f:
                    runs[name]["ranks"][r] = pickle.load(f)
    return runs


def _assert_params_close(got, want):
    assert got.keys() == want.keys()
    n = far = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 6 * W.LR, (k, diff.max())
        far += int((diff > 1e-5).sum())
        n += diff.size
    assert far <= 1e-3 * n, (far, n)


@pytest.mark.parametrize("name", list(W.HYBRID_CONFIGS))
def test_hybrid_step_matches_the_jax_single_device_step(jax_runs, port_runs,
                                                       name):
    _, want_losses, want_final = jax_runs[_jax_key(name)]
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=2e-4)
    assert run["losses"][2] < run["losses"][0]
    _assert_params_close(run["params"], want_final)
    # every rank of the mesh reports the global loss
    for r, rk in run["ranks"].items():
        assert rk["losses"] == run["losses"], r


def _stage(name):
    c = W.HYBRID_CONFIGS[name]
    return 3 if "group_sharded" in c else c.get("stage", 0) \
        if c.get("sharding", 1) > 1 else 0


def _tiny_params(name):
    """name -> (full shape, tp annotation) of the configuration's tiny
    Llama."""
    tie = W.HYBRID_CONFIGS[name].get("tie_word_embeddings", False)
    m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY, dtype="float32",
                                             tie_word_embeddings=tie),
                         device="cpu")
    return {k: (tuple(p.shape), getattr(p, "pspec", None))
            for k, p in m.named_parameters()}


def _local_shape(shape, spec, m):
    """One rank's block of a ``shape`` array placed by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // m.axis_size(e) for n, e in zip(shape, spec))


@pytest.mark.parametrize("name", list(W.HYBRID_CONFIGS))
def test_rank_blocks_are_what_the_placement_rules_give(port_runs, name):
    stage = _stage(name)
    run = port_runs[name]
    tiny_params = _tiny_params(name)
    assert run["ranks"], name
    for r, rk in run["ranks"].items():
        s = rk["shape"]
        m = mesh.build_mesh(dp=s["dp"], tp=s["tp"], sharding=s["sharding"],
                            world_size=WORLD, rank=r)
        want_p, want_o = {}, {}
        for k, (shape, ann) in tiny_params.items():
            ps = mesh.infer_param_pspec(shape, ann, stage, mesh=m)
            want_p[k] = _local_shape(shape, ps, m)
            os_ = mesh.opt_state_pspec(ps, shape, shape, stage, mesh=m)
            for leaf in ("moment1", "moment2"):
                want_o[f"{k}/{leaf}"] = _local_shape(shape, os_, m)
            for leaf in ("beta1_pow", "beta2_pow"):
                want_o[f"{k}/{leaf}"] = ()
        assert {k: v[0] for k, v in rk["params"].items()} == want_p, r
        assert {k: v[0] for k, v in rk["opt"].items()} == want_o, r
        # and so the bytes: fp32 parameters, moments and beta powers
        held = sum(int(np.prod(sh)) * size for d in (rk["params"], rk["opt"])
                   for sh, size in d.values())
        assert held == 4 * sum(int(np.prod(sh)) for d in (want_p, want_o)
                               for sh in d.values()), r


@pytest.mark.parametrize("name", list(W.HYBRID_CONFIGS))
def test_global_norm_over_rank_blocks_is_the_world1_norm(port_runs, name):
    """``ClipGradByGlobalNorm.global_norm`` on each rank's blocks (a
    tp-sharded block summed over tp, a sharding block over sharding, a
    replicated one counted once) is the norm of the full gradients."""
    want = np.sqrt(sum(np.sum(W.clip_grad(k, s).astype(np.float64) ** 2)
                       for k, (s, _) in _tiny_params(name).items()))
    for r, rk in port_runs[name]["ranks"].items():
        np.testing.assert_allclose(rk["global_norm"], want, rtol=1e-5,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(W.HYBRID_CONFIGS))
def test_rank_state_dict_restores_the_trajectory(port_runs, name):
    """Each rank's ``state_dict()`` (its blocks) taken after step 3 and
    loaded back after step 4 gives step 4's loss again."""
    for r, rk in port_runs[name]["ranks"].items():
        assert rk["replayed"][0] == rk["replayed"][1], r


def test_save_group_sharded_model_writes_the_full_weights(port_runs):
    run = port_runs["group_sharded_p_g_os"]
    assert run["ranks"][0]["saved"] == ["model.pdopt.0", "model.pdopt.1",
                                        "model.pdopt.2", "model.pdopt.3",
                                        "model.pdopt.4", "model.pdopt.5",
                                        "model.pdopt.6", "model.pdopt.7",
                                        "model.pdparams"]
    full = torch.load(run["dir"] / "group_sharded_p_g_os" / "model.pdparams",
                      weights_only=False)
    assert full.keys() == run["params"].keys()
    for k, v in full.items():
        np.testing.assert_array_equal(v, run["params"][k])


def test_stage3_rank_holds_a_quarter_of_the_large_tp_free_bytes(port_runs):
    run = port_runs["sharding4_stage3"]
    tiny_params = _tiny_params("sharding4_stage3")
    assert sorted(run["ranks"]) == [0, 1, 2, 3]
    for r, rk in run["ranks"].items():
        for k, (shape, _) in tiny_params.items():
            full = int(np.prod(shape)) * 4              # fp32 bytes
            held = int(np.prod(rk["params"][k][0])) * rk["params"][k][1]
            opt = sum(int(np.prod(rk["opt"][f"{k}/{n}"][0])) * 4
                      for n in ("moment1", "moment2"))
            if full // 4 >= 1024:
                assert held * 4 == full and opt * 4 == 2 * full, (r, k)
            else:
                assert held == full and opt == 2 * full, (r, k)


# -- what stays out -----------------------------------------------------------

def _tiny(**kw):
    return LlamaForCausalLM(dataclasses.replace(
        LLAMA_TINY, dtype="float32", num_hidden_layers=1, **kw),
        device="cpu")


# what each comm-efficient strategy still refuses, as the JAX step does
# (they run: tests/test_torch_comm_opt.py, tests/test_torch_comm_efficient.py)
_COMM_REFUSED = {"comm_opt": dict(grad_clip=True),
                 "localsgd": dict(fields={"dgc": True}),
                 "dgc": dict(fields={"amp": True}),
                 "fp16_allreduce": dict(kw={"accumulate_steps": 2})}


def _train_step_raises(field):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    how = _COMM_REFUSED.get(field, {})
    model = _tiny()
    s = fleet.DistributedStrategy()
    setattr(s, field, True)
    for k, v in how.get("fields", {}).items():
        setattr(s, k, v)
    clip = ClipGradByGlobalNorm(1.0) if how.get("grad_clip") else None
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(parameters=model.parameters(), grad_clip=clip), s)
    opt.make_train_step(model, lambda m, x, y: m(x, labels=y),
                        **how.get("kw", {}))


@pytest.mark.parametrize("case,exc,match", [
    ("pp_degree", NotImplementedError, "item 4: multi-GPU, pipeline"),
    ("sep_degree", NotImplementedError, "item 4: multi-GPU, sequence"),
    ("sequence_parallel", NotImplementedError, "item 4: multi-GPU, sequence"),
    pytest.param("comm_opt", NotImplementedError, "grad_clip is not",
                 id="comm_opt-NotImplementedError-item 4"),
    pytest.param("localsgd", NotImplementedError, "mutually exclusive",
                 id="localsgd-NotImplementedError-item 4"),
    pytest.param("dgc", NotImplementedError, "amp is not supported",
                 id="dgc-NotImplementedError-item 4"),
    pytest.param("fp16_allreduce", NotImplementedError,
                 "not supported by the fp16_allreduce",
                 id="fp16_allreduce-NotImplementedError-item 4"),
    ("engine_tp", NotImplementedError, "multi-GPU"),
    ("tp_not_dividing_kv_heads", ValueError, "num_key_value_heads"),
    ("generate_on_a_split_model", NotImplementedError, "item 4"),
])
def test_strategy_surface(case, exc, match):
    with pytest.raises(exc, match=match):
        if case in ("pp_degree", "sep_degree"):
            s = fleet.DistributedStrategy()
            s.hybrid_configs[case] = 2
            # sep and pp run alone or with dp
            # (tests/test_torch_sep_train.py, tests/test_torch_pp_train.py);
            # beside sharding the JAX guard refuses them
            s.hybrid_configs["sharding_degree"] = 2
            fleet.init(is_collective=True, strategy=s)
        elif case == "sequence_parallel":
            # a sequence-parallel model placed on sep beside tp: refused,
            # as the JAX guard refuses it
            place_model(_tiny(sequence_parallel=True),
                        mesh.build_mesh(sep=2, tp=2, world_size=4, rank=0),
                        0)
        elif case == "engine_tp":
            # Engine(tp=N) takes the whole model and places its own
            # shards: a model that fleet already split is refused
            from paddle_tpu_torch.serving import Engine
            model = _tiny()
            model.lm_head.weight.placement = (None, "tp")
            Engine(model, n_slots=1, max_len=32, block_size=8, tp=2)
        elif case == "generate_on_a_split_model":
            model = _tiny()
            model.lm_head.weight.placement = (None, "tp")
            model.generate(np.zeros((1, 4), np.int64), max_new_tokens=2)
        elif case == "tp_not_dividing_kv_heads":
            # LLAMA_TINY: 8 heads, 4 KV heads; tp 8 splits only the first
            place_model(_tiny(), mesh.build_mesh(tp=8, world_size=8,
                                                 rank=0), 0)
        else:
            _train_step_raises(case)


def test_world_one_stage3_strategy_is_the_single_gpu_step():
    """At world size 1 every collective is the identity: a stage-3,
    tp-1 strategy trains exactly as no strategy does."""
    ids = _batch()[:2]
    runs = []
    for stage in (0, 3):
        torch.manual_seed(0)
        model = _tiny()
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.02)
        s = fleet.DistributedStrategy()
        s.hybrid_configs["sharding_degree"] = 1
        s.sharding = stage > 0
        s.sharding_configs["sharding_stage"] = stage
        opt = fleet.distributed_optimizer(
            optimizer.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()), s)
        step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
        runs.append([float(step(ids, ids)) for _ in range(2)])
    assert runs[0] == runs[1]
