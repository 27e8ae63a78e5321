"""GPT training on the port (one rank and tensor parallel) against the
JAX package's single-device step.

The JAX side: ``GPT_TINY`` (fp32, dropout 0), AdamW lr 1e-3, 3 steps on
one 4 x 32 batch (labels = ids, shifted inside the model). Its initial
weights reach every rank through ``load_numpy_state_dict``. Every
configuration of ``torch_dist_worker.GPT_CONFIGS`` (world 1; tp2; tp4;
dp2 x tp2; sharding2 at stage 3, alone and beside tp2) trains in one
module-scoped spawn of 4 gloo ranks on the CPU:

- losses within rtol 2e-4 (the JAX package's own hybrid bound,
  ``tests/test_distributed.py:62``);
- the parameters after ``gather_state_dict``: every element within rtol
  2e-4 (atol 1e-6, for elements near zero), except at most 0.1% of them,
  none beyond 6 lr (``tests/test_torch_hybrid_train.py``'s rule, with
  rtol 2e-4 for its 1e-5: Adam's first update is lr * sign(g), so an
  element whose gradient is at round-off level moves by up to 2 lr a
  step in either package). The k third of each ``qkv.bias`` is held to an
  absolute 1e-4 instead: softmax cancels a bias added to every key, so
  that slice's true gradient is 0 and AdamW moves it by round-off on
  both sides (up to 5.2e-5 apart on values of at most 3.6e-5 in
  ROADMAP's probe);
- the gathered state dict has the JAX model's keys and shapes, and its
  qkv in the JAX layout (which the comparison above needs); rank r's
  block of ``qkv`` is block r of the columns in
  ``_gpt_qkv_tp_permutation``'s order: the q, k and v columns of its
  heads;
- at stage 3 the blocks are found as units.
"""
import dataclasses
import pickle

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.distributed.fleet.placement import place_model
from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM
from paddle_tpu_torch.text.models.gpt import _gpt_qkv_tp_permutation

WORLD = 4
H = GPT_TINY.hidden_size


def _batch():
    return np.random.default_rng(11).integers(
        0, GPT_TINY.vocab_size, (4, 32)).astype(np.int64)


def _arrays(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_run():
    """(initial weights, losses, final weights) of the JAX single-device
    step."""
    jax_mesh.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        model = jax_fleet.distributed_model(jgpt.GPTForCausalLM(
            dataclasses.replace(jgpt.GPT_TINY, dropout=0.0)))
        init = _arrays(model)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
        ids = paddle.to_tensor(_batch().astype(np.int32))
        losses = [float(step(ids, ids).numpy()) for _ in range(W.STEPS)]
        return init, losses, _arrays(model)
    finally:
        jax_mesh.set_mesh(None)


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("gpt")
    np.savez(out / "init.npz", **jax_run[0])
    np.savez(out / "batch.npz", ids=_batch())
    dist.spawn(W.gpt_worker, args=(str(out), str(out / "init.npz"),
                                   str(out / "batch.npz"),
                                   list(W.GPT_CONFIGS)),
               nprocs=WORLD, timeout=600)
    runs = {}
    for name in W.GPT_CONFIGS:
        with open(out / f"{name}.pkl", "rb") as f:
            runs[name] = pickle.load(f)
        runs[name]["ranks"] = {}
        for r in range(WORLD):
            p = out / f"{name}.r{r}.pkl"
            if p.exists():
                with open(p, "rb") as f:
                    runs[name]["ranks"][r] = pickle.load(f)
    return runs


def _k_third(name):
    """The k third of a ``qkv.bias`` (columns h..2h), else None."""
    return slice(H, 2 * H) if name.endswith("qkv.bias") else None


def _assert_params_close(got, want):
    """Every element within rtol 2e-4 (atol 1e-6), except at most 0.1%
    of them, none beyond 6 lr; the k third of each ``qkv.bias`` within an
    absolute 1e-4 instead (see the module docstring)."""
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    n = far = 0
    for k, w in want.items():
        g = got[k]
        if k.endswith("qkv.bias"):
            k3 = slice(H, 2 * H)
            np.testing.assert_allclose(g[k3], w[k3], rtol=0, atol=1e-4,
                                       err_msg=k)
            g, w = np.delete(g, k3), np.delete(w, k3)
        diff = np.abs(g - w)
        assert diff.max() <= 6 * W.LR, (k, diff.max())
        far += int((diff > 2e-4 * np.abs(w) + 1e-6).sum())
        n += diff.size
    assert far <= 1e-3 * n, (far, n)


@pytest.mark.parametrize("name", list(W.GPT_CONFIGS))
def test_gpt_step_matches_the_jax_single_device_step(jax_run, port_runs,
                                                    name):
    _, want_losses, want_final = jax_run
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=2e-4)
    assert run["losses"][2] < run["losses"][0]
    _assert_params_close(run["params"], want_final)
    for r, rk in run["ranks"].items():      # every rank the global loss
        assert rk["losses"] == run["losses"], r


@pytest.mark.parametrize("name", ["tp2", "tp4", "dp2_tp2",
                                  "sharding2_tp2_stage3"])
def test_rank_blocks_are_the_heads_of_the_rank(port_runs, name):
    """Rank r's qkv holds the q, k and v columns of its heads (and its
    bias the same), fc1 its contiguous columns, proj and fc2 its rows;
    the rest is whole unless stage 3 sharded it."""
    tp = W.GPT_CONFIGS[name]["mp"]
    full = port_runs[name]["params"]
    perm = _gpt_qkv_tp_permutation(H, tp)
    for r, rk in port_runs[name]["ranks"].items():
        t = r % tp
        blk = rk["blocks"]
        for i in range(GPT_TINY.num_hidden_layers):
            p = f"gpt.blocks.{i}."
            n = 3 * H // tp
            cols = perm[t * n:(t + 1) * n]
            # the final weights, gathered and local: the same numbers
            np.testing.assert_array_equal(blk[p + "qkv.weight"],
                                          full[p + "qkv.weight"][:, cols])
            np.testing.assert_array_equal(blk[p + "qkv.bias"],
                                          full[p + "qkv.bias"][cols])
            f = GPT_TINY.intermediate_size // tp
            np.testing.assert_array_equal(
                blk[p + "fc1.weight"],
                full[p + "fc1.weight"][:, t * f:(t + 1) * f])
            np.testing.assert_array_equal(
                blk[p + "proj.weight"],
                full[p + "proj.weight"][t * H // tp:(t + 1) * H // tp])
            np.testing.assert_array_equal(
                blk[p + "fc2.weight"],
                full[p + "fc2.weight"][t * f:(t + 1) * f])
            for k in ("proj.bias", "fc2.bias", "ln_1.weight"):
                np.testing.assert_array_equal(blk[p + k], full[p + k])


def test_stage3_units_are_the_blocks_and_the_model(port_runs):
    """``Stage3`` takes its units from the ``blocks`` ModuleList: alone,
    each block gathers its sharded parameters; beside tp every block
    parameter of 1024 elements or more is tp-split, so only the model's
    own (wte, wpe, the head) are gathered, by the model's unit."""
    for name, want in (("sharding2_stage3",
                        ["GPTBlock"] * GPT_TINY.num_hidden_layers
                        + ["GPTForCausalLM"]),
                       ("sharding2_tp2_stage3", ["GPTForCausalLM"])):
        for r, rk in port_runs[name]["ranks"].items():
            assert rk["units"] == want, (name, r)
            # the head, tp-free and of more than 1024 elements: sharded
            assert rk["blocks"]["lm_head.weight"].shape == (
                H, GPT_TINY.vocab_size // 2), (name, r)


def test_check_tensor_parallel_refuses_a_degree_that_splits_a_head():
    model = GPTForCausalLM(GPT_TINY, device="cpu")
    model.check_tensor_parallel(2)
    model.check_tensor_parallel(4)
    with pytest.raises(ValueError, match="num_attention_heads=4"):
        model.check_tensor_parallel(3)
    with pytest.raises(ValueError, match="num_attention_heads=4"):
        place_model(GPTForCausalLM(GPT_TINY, device="cpu"),
                    mesh.build_mesh(tp=8, world_size=8, rank=0), 0)
