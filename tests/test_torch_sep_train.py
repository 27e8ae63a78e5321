"""The port's sequence-parallel train step against the JAX package's
single-device one.

``torch_dist_worker.SEP_CONFIGS`` trains fp32 ``LLAMA_TINY`` with
``sequence_parallel=True`` through ``fleet`` (``sep_degree``) in one
module-scoped spawn of 8 gloo ranks on the CPU: sep4 ring, sep4 Ulysses,
sep2 ring with the fused head (``fused_ce_chunk=256``) and selective
remat, and dp2 x sep4 Ulysses (the JAX package's own sep configuration,
``tests/test_ulysses_attention.py``). Each rank holds ``[B, L/n]`` of a
4 x 32 batch. The labels of the dense head hold some -100 (ignored), on
rank 0's block and in the last rank's, and the last rank always has one
target fewer a row, so a mean of per-rank means is not the global mean.
The JAX side is the single-device step on the same initial weights and
batch (AdamW lr 1e-3, 3 steps); the JAX package holds its own sep run to
the single-device one at rtol 2e-4 (``tests/test_distributed.py:83-87``).

- Losses within rtol 2e-4, on every rank of the mesh;
- the parameters after 3 steps by ``test_torch_hybrid_train``'s rule;
- the model called on the whole sequence on the sep mesh, outside the
  step, gives the JAX logits;
- a sequence length that the sep degree does not divide is refused with
  the JAX ring's error.

Also the refusals, held as the JAX package's: sep beside sharding or tp
(the partial-manual guard), a model without sequence-parallel attention
on a sep mesh (Llama without ``sequence_parallel``, GPT, ERNIE-MoE; JAX's
GSPMD would gather the sequence there, a divergence ROADMAP Queue 3
keeps), Ulysses with heads the sep degree does not divide, and a
``sep_mode`` that is neither ring nor Ulysses.
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
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.distributed.fleet.placement import place_model
from paddle_tpu_torch.text.models import (GPT_TINY, ErnieMoEConfig,
                                          ErnieMoEForPretraining,
                                          GPTForCausalLM)
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM
from test_torch_hybrid_train import _assert_params_close

WORLD = 8


def _batch():
    """ids [4, 32]; dense labels with -100 on rank 0's block (sep4:
    positions 0-7) and the last rank's; fused labels = ids."""
    ids = np.random.default_rng(321).integers(
        0, LLAMA_TINY.vocab_size, (4, 32)).astype(np.int64)
    labels = ids.copy()
    labels[0, 3:6] = -100
    labels[2, 29] = -100
    return dict(ids=ids, labels=labels, labels_fused=ids.copy())


def _fused(name):
    return W.SEP_CONFIGS[name].get("fused_ce_chunk", 0)


def _jax_run(fused_ce_chunk):
    """(initial weights, losses, final weights, logits of the whole
    batch at the initial weights) of the JAX single-device train step."""
    jax_mesh.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        cfg = dataclasses.replace(JAX_TINY, dtype="float32",
                                  fused_ce_chunk=fused_ce_chunk)
        model = jax_fleet.distributed_model(JaxLlama(cfg))
        init = {k: np.asarray(v._data)
                for k, v in model.state_dict().items()}
        b = _batch()
        ids = paddle.to_tensor(b["ids"].astype(np.int32))
        logits = np.asarray(model(ids)._data)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model,
                                   lambda m, x, y: m(x, labels=y))
        labels = paddle.to_tensor(
            b["labels_fused" if fused_ce_chunk else "labels"].astype(
                np.int32))
        losses = [float(step(ids, labels).numpy()) for _ in range(W.STEPS)]
        final = {k: np.asarray(v._data)
                 for k, v in model.state_dict().items()}
    finally:
        jax_mesh.set_mesh(None)
    return init, losses, final, logits


@pytest.fixture(scope="module")
def jax_runs():
    return {c: _jax_run(c) for c in sorted({_fused(n)
                                            for n in W.SEP_CONFIGS})}


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    out = tmp_path_factory.mktemp("sep")
    for c, run in jax_runs.items():
        np.savez(out / f"init{c}.npz", **run[0])
    np.savez(out / "batch.npz", **_batch())
    inits = {n: str(out / f"init{_fused(n)}.npz") for n in W.SEP_CONFIGS}
    dist.spawn(W.sep_worker,
               args=(str(out), inits, str(out / "batch.npz"),
                     list(W.SEP_CONFIGS)),
               nprocs=WORLD, timeout=600)
    runs = {}
    for name, c in W.SEP_CONFIGS.items():
        with open(out / f"{name}.pkl", "rb") as f:
            runs[name] = pickle.load(f)
        runs[name]["ranks"] = {}
        for r in range(c.get("dp", 1) * c["sep"]):
            with open(out / f"{name}.r{r}.pkl", "rb") as f:
                runs[name]["ranks"][r] = pickle.load(f)
    return runs


@pytest.mark.parametrize("name", list(W.SEP_CONFIGS))
def test_sep_step_matches_the_jax_single_device_step(jax_runs, port_runs,
                                                    name):
    _, want_losses, want_final, _ = jax_runs[_fused(name)]
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=2e-4)
    assert run["losses"][2] < run["losses"][0]
    _assert_params_close(run["params"], want_final)
    # every rank of the mesh reports the global loss
    for r, rk in run["ranks"].items():
        np.testing.assert_allclose(rk["losses"], run["losses"], rtol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(W.SEP_CONFIGS))
def test_whole_sequence_on_a_sep_mesh_gets_the_jax_logits(jax_runs,
                                                         port_runs, name):
    """Called outside the step, the model takes its input as the whole
    sequence (no shard declared) and attends over all of it."""
    want = jax_runs[_fused(name)][3]
    np.testing.assert_allclose(port_runs[name]["logits"], want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(W.SEP_CONFIGS))
def test_sequence_the_sep_degree_does_not_divide_is_refused(port_runs,
                                                           name):
    n = W.SEP_CONFIGS[name]["sep"]
    assert port_runs[name]["odd_length"] == \
        f"seq len 31 not divisible by {n}"


# -- refusals -----------------------------------------------------------------

def _llama(**kw):
    return LlamaForCausalLM(dataclasses.replace(
        LLAMA_TINY, dtype="float32", num_hidden_layers=1, **kw),
        device="cpu")


def _sep_mesh(**degrees):
    n = int(np.prod(list(degrees.values())))
    return mesh.build_mesh(world_size=n, rank=0, **degrees)


@pytest.mark.parametrize("beside", ["sharding_degree", "mp_degree"])
def test_sep_beside_sharding_or_tp_strategy_is_refused(beside):
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(sep_degree=2, **{beside: 2})
    with pytest.raises(NotImplementedError,
                       match="partial-manual shard_map guard"):
        fleet.init(is_collective=True, strategy=s)


@pytest.mark.parametrize("beside", ["sharding", "tp"])
def test_sep_beside_sharding_or_tp_placement_is_refused(beside):
    with pytest.raises(NotImplementedError,
                       match="item 4: multi-GPU, sequence parallel"):
        place_model(_llama(sequence_parallel=True),
                    _sep_mesh(sep=2, **{beside: 2}), 0)


@pytest.mark.parametrize("what", ["llama", "gpt", "ernie_moe"])
def test_model_without_sequence_parallel_attention_is_refused(what):
    if what == "llama":
        model = _llama()
    elif what == "gpt":
        model = GPTForCausalLM(GPT_TINY, device="cpu")
    else:
        model = ErnieMoEForPretraining(ErnieMoEConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, num_experts=2),
            device="cpu")
    with pytest.raises(NotImplementedError,
                       match="no sequence-parallel attention"):
        place_model(model, _sep_mesh(sep=2), 0)
    # and so by the train step, which places the model it is given
    mesh.set_mesh(_sep_mesh(sep=2))
    try:
        with pytest.raises(NotImplementedError,
                           match="no sequence-parallel attention"):
            fleet.make_train_step(model, optimizer.AdamW(
                parameters=model.parameters()), lambda m, x, y: m(x))
    finally:
        mesh.set_mesh(None)


def test_ulysses_heads_the_sep_degree_does_not_divide_are_refused():
    # LLAMA_TINY: 8 heads
    with pytest.raises(ValueError, match="num heads 8 not divisible by "
                                         "axis size 3"):
        place_model(_llama(sequence_parallel=True, sep_mode="ulysses"),
                    _sep_mesh(sep=3), 0)
    place_model(_llama(sequence_parallel=True, sep_mode="ring"),
                _sep_mesh(sep=3), 0)


def test_sep_mode_must_be_ring_or_ulysses():
    with pytest.raises(ValueError, match="sep_mode='all_gather'"):
        _llama(sequence_parallel=True, sep_mode="all_gather")
