"""The port's pipeline-parallel train steps against the JAX package's
single-device step.

``torch_dist_worker.PP_CONFIGS`` trains fp32 ``LlamaForCausalLMPipe``
(LLAMA_TINY widths, 4 layers, untied) through ``fleet`` with
``pp_degree`` in one module-scoped spawn of 4 gloo ranks on the CPU:
GPipe (``make_train_step``: the model's forward runs ``spmd_pipeline``,
autograd gives the backward) at pp 2 and 4; 1F1B
(``make_1f1b_train_step``) at pp 2 with 2 and 4 micro-batches and at pp
4; dp2 x pp2 under both schedules (the JAX package's own 1F1B
configuration, ``tests/test_pp_1f1b_train_step.py``); and GPipe with
``strategy.pipeline`` and ``accumulate_steps=2``. The JAX side is the
single-device step of ``LlamaForCausalLMPipe`` (pp 1: ``_decoder_chunk``
under ``lax.scan``) on the same initial weights and 8 x 32 batch, AdamW
lr 1e-3, 3 steps.

- Losses within rtol 2e-4 (the JAX package's hybrid bound,
  ``tests/test_distributed.py:62``) on every rank, the parameters after 3
  steps by ``test_torch_hybrid_train``'s rule;
- the port's 1F1B against its GPipe on the same micro-batches at JAX's
  1F1B bound (loss rtol 1e-5, parameters rtol 5e-4 / atol 1e-6);
- each rank holds only its chunk of the stacked weights, and the
  replicated embedding, norm and head are bit-identical on every rank
  after every step;
- GPipe holds n_micro micro-batches, 1F1B at most P - p.

Also ``LlamaForCausalLMPipe``'s logits and loss against JAX's at pp 1,
and the refusals: pp beside sharding, tp or sep (the JAX partial-manual
guard's words), and tied embeddings under 1F1B (JAX's message).
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
from paddle_tpu.text.models.llama_pipe import LlamaForCausalLMPipe as JaxPipe
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.distributed.fleet.placement import place_model
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text.models import LlamaForCausalLMPipe
from paddle_tpu_torch.text.models.llama import LLAMA_TINY
from test_torch_hybrid_train import _assert_params_close

WORLD = 4
CFG = dataclasses.replace(LLAMA_TINY, dtype="float32",
                          num_hidden_layers=W.PP_LAYERS)


def _batch():
    rng = np.random.default_rng(0)
    return dict(ids=rng.integers(0, CFG.vocab_size, (8, 32)),
                labels=rng.integers(0, CFG.vocab_size, (8, 32)))


@pytest.fixture(scope="module")
def jax_run():
    """(initial weights, logits and loss at them, losses, final weights)
    of the JAX single-device step."""
    jax_mesh.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        model = jax_fleet.distributed_model(JaxPipe(dataclasses.replace(
            JAX_TINY, dtype="float32", num_hidden_layers=W.PP_LAYERS)))
        init = {k: np.asarray(v._data)
                for k, v in model.state_dict().items()}
        b = _batch()
        ids = paddle.to_tensor(b["ids"].astype(np.int32))
        labels = paddle.to_tensor(b["labels"].astype(np.int32))
        logits = np.asarray(model(ids)._data)
        loss0 = float(model(ids, labels=labels).numpy())
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=W.LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
        losses = [float(step(ids, labels).numpy()) for _ in range(W.STEPS)]
        final = {k: np.asarray(v._data)
                 for k, v in model.state_dict().items()}
    finally:
        jax_mesh.set_mesh(None)
    return init, (logits, loss0), losses, final


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    np.savez(out / "init.npz", **jax_run[0])
    np.savez(out / "batch.npz", **_batch())
    dist.spawn(W.pp_worker,
               args=(str(out), str(out / "init.npz"),
                     str(out / "batch.npz"), list(W.PP_CONFIGS)),
               nprocs=WORLD, timeout=600)
    runs = {}
    for name, c in W.PP_CONFIGS.items():
        with open(out / f"{name}.pkl", "rb") as f:
            runs[name] = pickle.load(f)
        runs[name]["ranks"] = {}
        for r in range(c.get("dp", 1) * c["pp"]):
            with open(out / f"{name}.r{r}.pkl", "rb") as f:
                runs[name]["ranks"][r] = pickle.load(f)
    return runs


def test_pipe_model_matches_jax_at_pp1(jax_run):
    init, (want_logits, want_loss), _, _ = jax_run
    mesh.set_mesh(None)
    model = LlamaForCausalLMPipe(CFG, device="cpu")
    load_numpy_state_dict(model, init)
    b = _batch()
    with torch.no_grad():
        logits = model(b["ids"]).numpy()
        loss = float(model(b["ids"], labels=b["labels"]))
    assert np.linalg.norm(logits - want_logits) <= \
        1e-5 * np.linalg.norm(want_logits)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)


@pytest.mark.parametrize("name", list(W.PP_CONFIGS))
def test_pp_step_matches_the_jax_single_device_step(jax_run, port_runs,
                                                   name):
    _, _, want_losses, want_final = jax_run
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], want_losses, rtol=2e-4)
    assert run["losses"][2] < run["losses"][0]
    _assert_params_close(run["params"], want_final)
    for r, rk in run["ranks"].items():           # every rank's loss
        np.testing.assert_allclose(rk["losses"], run["losses"], rtol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("gpipe,onef1b", [
    ("gpipe_pp2", "1f1b_pp2_micro2"), ("gpipe_pp4", "1f1b_pp4"),
    ("gpipe_dp2_pp2", "1f1b_dp2_pp2")])
def test_1f1b_step_matches_the_gpipe_step(port_runs, gpipe, onef1b):
    want, got = port_runs[gpipe], port_runs[onef1b]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=5e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(W.PP_CONFIGS))
def test_rank_holds_its_chunk_and_equal_replicas(port_runs, name):
    c = W.PP_CONFIGS[name]
    ranks = port_runs[name]["ranks"]
    full = port_runs[name]["params"]
    for r, rk in ranks.items():
        for k, shape in rk["shapes"].items():
            want = full[k].shape
            if k not in W.REPLICATED:
                want = (want[0] // c["pp"], *want[1:])
            assert shape == want, (r, k)
        assert rk["stage"] == r // c.get("dp", 1)
        # bit-identical replicated parameters after every step
        assert rk["digests"] == ranks[0]["digests"], r


@pytest.mark.parametrize("name", list(W.PP_CONFIGS))
def test_micro_batches_in_flight_per_step(port_runs, name):
    c = W.PP_CONFIGS[name]
    dp, pp = c.get("dp", 1), c["pp"]
    for r, rk in port_runs[name]["ranks"].items():
        p = r // dp
        m = c.get("n_micro") or pp
        want = min(pp - p, m) if c.get("schedule") == "1f1b" else m
        assert rk["in_flight"] == [want] * W.STEPS, (r, rk["in_flight"])


# -- refusals -----------------------------------------------------------------

def _pipe(**kw):
    return LlamaForCausalLMPipe(dataclasses.replace(CFG, **kw), device="cpu")


@pytest.mark.parametrize("beside", ["sharding_degree", "mp_degree",
                                    "sep_degree"])
def test_pp_beside_sharding_tp_or_sep_strategy_is_refused(beside):
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(pp_degree=2, **{beside: 2})
    with pytest.raises(NotImplementedError,
                       match="pipeline parallel over 'pp' beside .*"
                             "partial-manual shard_map guard.*item 4: "
                             "multi-GPU, pipeline parallel"):
        fleet.init(is_collective=True, strategy=s)


@pytest.mark.parametrize("beside", ["sharding", "tp", "sep"])
def test_pp_beside_sharding_tp_or_sep_placement_is_refused(beside):
    m = mesh.build_mesh(pp=2, world_size=4, rank=0, **{beside: 2})
    with pytest.raises(NotImplementedError,
                       match="partial-manual shard_map guard"):
        place_model(_pipe(), m, 0)


def test_tied_embeddings_under_1f1b_are_refused_as_jax_does():
    model = _pipe(tie_word_embeddings=True)
    with pytest.raises(NotImplementedError) as got:
        fleet.make_1f1b_train_step(model, optimizer.AdamW(
            parameters=model.parameters()))
    jax_model = JaxPipe(dataclasses.replace(
        JAX_TINY, dtype="float32", num_hidden_layers=2,
        tie_word_embeddings=True))
    with pytest.raises(NotImplementedError) as want:
        jax_model.pipeline_parts()
    assert str(got.value) == str(want.value)
