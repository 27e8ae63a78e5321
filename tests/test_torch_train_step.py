"""The PyTorch port's train step against the JAX package's.

``fleet.distributed_optimizer(AdamW).make_train_step`` on ``LLAMA_TINY``
in fp32, built as ``tests/test_distributed.py`` builds the JAX one, with
the JAX model's initial weights carried into the port through
``load_numpy_state_dict``: the same batch for 3 steps gives the same
losses and the same parameters after them. Also with the fused LM head
(``fused_ce_chunk``); ``accumulate_steps=2`` and remat (full and
selective) give the full-batch, no-remat step.

Tolerances: the losses agree within rtol 1e-5 (fp32, the same arithmetic
in another reduction order). Parameters agree within 1e-5 except where
a gradient is at rounding-noise level: Adam's first update there is
``lr * sign(g)``, so a sign flipped by reduction order moves an element
by up to ``2 * lr`` per step. At most 0.1% of the elements may differ by
more than 1e-5, and none by more than ``6 * lr``.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

LR = 1e-3
STEPS = 3


def _batch():
    return np.random.default_rng(123).integers(
        0, LLAMA_TINY.vocab_size, (4, 32)).astype(np.int32)


def _jax_run(**cfg_kw):
    """(initial weights, losses, final weights) of the JAX train step;
    leaves no global mesh behind for the next test in the process."""
    mesh_mod.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        cfg = dataclasses.replace(JAX_TINY, dtype="float32", **cfg_kw)
        model = jax_fleet.distributed_model(JaxLlama(cfg))
        init = {k: np.asarray(v._data)
                for k, v in model.state_dict().items()}
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model,
                                   lambda m, ids, lbl: m(ids, labels=lbl))
        ids = paddle.to_tensor(_batch())
        losses = [float(step(ids, ids).numpy()) for _ in range(STEPS)]
        final = {k: np.asarray(v._data)
                 for k, v in model.state_dict().items()}
    finally:
        mesh_mod.set_mesh(None)
    return init, losses, final


def _port_run(init, accumulate_steps=None, **cfg_kw):
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", **cfg_kw)
    model = fleet.distributed_model(LlamaForCausalLM(cfg, device="cpu"))
    load_numpy_state_dict(model, init)
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(learning_rate=LR, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, ids, lbl: m(ids, labels=lbl),
                               accumulate_steps=accumulate_steps)
    ids = _batch()
    losses = [float(step(ids, ids)) for _ in range(STEPS)]
    final = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return losses, final


def _assert_params_close(got, want):
    assert got.keys() == want.keys()
    n = far = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > 1e-5).sum())
        n += diff.size
    assert far <= 1e-3 * n, (far, n)


@pytest.fixture(scope="module")
def jax_base():
    return _jax_run()


def test_losses_and_params_match_jax(jax_base):
    init, want_losses, want_final = jax_base
    losses, final = _port_run(init)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[2] < losses[0]
    _assert_params_close(final, want_final)


def test_fused_ce_head_matches_jax():
    init, want_losses, want_final = _jax_run(fused_ce_chunk=256)
    losses, final = _port_run(init, fused_ce_chunk=256)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params_close(final, want_final)


def test_accumulate_steps_gives_the_full_batch_step(jax_base):
    """Two micro-batches of 2: the mean of their losses and the mean of
    their gradients are the full batch's, so the JAX full-batch step's
    losses and parameters hold."""
    init, want_losses, want_final = jax_base
    losses, final = _port_run(init, accumulate_steps=2)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params_close(final, want_final)


@pytest.mark.parametrize("remat", [True, "selective"])
def test_remat_gives_the_no_remat_losses(jax_base, remat):
    init, want_losses, want_final = jax_base
    losses, final = _port_run(init, remat=remat)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params_close(final, want_final)


def test_strategy_options_outside_the_slice_raise():
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    opt = optimizer.AdamW(parameters=model.parameters())
    loss_fn = (lambda m, ids, lbl: m(ids, labels=lbl))
    for field, item in (("asp", "item 9"), ("lamb", "item 9")):
        s = fleet.DistributedStrategy()
        setattr(s, field, True)
        with pytest.raises(NotImplementedError, match=item):
            fleet.distributed_optimizer(opt, s).make_train_step(model,
                                                                loss_fn)
    # amp runs since the amp slice (tests/test_torch_amp.py): the strategy
    # routes the step to O1, as the JAX step
    s = fleet.DistributedStrategy()
    s.amp = True
    assert fleet.distributed_optimizer(opt, s).make_train_step(
        model, loss_fn).amp_level == "O1"
    # dgc runs since the comm-efficient slice
    # (tests/test_torch_comm_efficient.py), with SGD or Momentum only, as
    # the JAX step
    s = fleet.DistributedStrategy()
    s.dgc = True
    with pytest.raises(TypeError, match="DGC requires SGD/Momentum"):
        fleet.distributed_optimizer(opt, s).make_train_step(model, loss_fn)
    # dp, mp and sharding degrees run since the multi-GPU slice
    # (tests/test_torch_hybrid_train.py), sep alone or with dp since the
    # sequence-parallel slice (tests/test_torch_sep_train.py), pp alone
    # or with dp since the pipeline slice (tests/test_torch_pp_train.py);
    # sep or pp beside mp still raise
    for degree in ("pp_degree", "sep_degree"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs[degree] = 2
        s.hybrid_configs["mp_degree"] = 2
        with pytest.raises(NotImplementedError, match=degree):
            fleet.distributed_optimizer(opt, s).make_train_step(model,
                                                                loss_fn)
    o1 = fleet.make_train_step(model, opt, loss_fn, amp_level="O1")
    assert (o1.amp_level, o1.amp_dtype, o1._scaler_cfg) == ("O1",
                                                            "bfloat16", None)
    s = fleet.DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs["k_steps"] = 2
    step = fleet.distributed_optimizer(opt, s).make_train_step(model,
                                                               loss_fn)
    assert step.accumulate_steps == 2
    s = fleet.DistributedStrategy()
    s.pipeline = True
    s.pipeline_configs["accumulate_steps"] = 4
    assert fleet.distributed_optimizer(opt, s).make_train_step(
        model, loss_fn).accumulate_steps == 4
    with pytest.raises(ValueError, match="not divisible"):
        step(np.zeros((3, 8), np.int64), np.zeros((3, 8), np.int64))


def test_state_dict_round_trip_restores_the_trajectory():
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    opt = optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    step = fleet.make_train_step(model, opt,
                                 lambda m, ids, lbl: m(ids, labels=lbl))
    ids = _batch()
    step(ids, ids)
    snap = {"params": {k: v.clone() for k, v in
                       step.state_dict()["params"].items()},
            "opt": {k: {n: t.clone() for n, t in st.items()}
                    for k, st in step.state_dict()["opt"].items()}}
    a = float(step(ids, ids))
    step.load_state_dict(snap)
    assert float(step(ids, ids)) == a
