"""ERNIE-MoE of the PyTorch port against the JAX package
(``paddle_tpu/text/models/ernie_moe.py``), and the layers it adds to the
port (``LayerNorm``, the biased ``Linear``, ``Dropout``, the GELUs).

``ERNIE_MOE_TINY`` in fp32 with dropout 0, its MoE layers set to sparse
dispatch with the ragged expert kernel on both sides, the JAX model's
weights carried across with ``load_numpy_state_dict``: the same state
dict keys, the same logits and loss, and through
``fleet.distributed_optimizer(AdamW).make_train_step`` the same losses
and parameters over 3 steps on one batch. The default (auto, here dense)
dispatch gives the same forward too.

Tolerances: layers and forward, fp32 in another order: 1e-5. Train
steps: the rule of ``tests/test_torch_train_step.py`` — losses within
rtol 1e-5; parameters within 1e-5 except at most 0.1% of the elements
(Adam's first update is ``lr * sign(g)``, so a rounding-level gradient
whose sign flips moves an element by up to ``2 * lr`` per step), none by
more than ``6 * lr``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.nn import functional as JF
from paddle_tpu.text.models.ernie_moe import ERNIE_MOE_TINY as JAX_TINY
from paddle_tpu.text.models.ernie_moe import \
    ErnieMoEForPretraining as JaxErnie
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.text.models import ERNIE_MOE_TINY, ErnieMoEForPretraining

LR = 1e-3
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch():
    rng = np.random.default_rng(321)
    return (rng.integers(0, ERNIE_MOE_TINY.vocab_size, (2, 32)).astype(
        np.int32), rng.integers(0, ERNIE_MOE_TINY.vocab_size, (2, 32)).astype(
        np.int32))


def _moe_layers(model):
    return [b.moe for b in model.ernie.blocks if b.use_moe]


def _set_sparse_ragged(model):
    for m in _moe_layers(model):
        m.dispatch_mode = "sparse"
        m.expert_kernel = "ragged"


def _jax_model(sparse):
    paddle.seed(0)
    model = JaxErnie(dataclasses.replace(JAX_TINY, dropout=0.0))
    if sparse:
        _set_sparse_ragged(model)
    return model


def _arrays(jax_model):
    return {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}


def _port_model(init, sparse):
    model = ErnieMoEForPretraining(
        dataclasses.replace(ERNIE_MOE_TINY, dropout=0.0), device="cpu")
    if sparse:
        _set_sparse_ragged(model)
    load_numpy_state_dict(model, init)
    return model


def test_state_dict_keys_and_shapes_match_jax():
    jm = _jax_model(sparse=False)
    pt.seed(0)
    tm = ErnieMoEForPretraining(ERNIE_MOE_TINY, device="cpu")
    want = {k: tuple(v.shape) for k, v in _arrays(jm).items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert "ernie.blocks.1.moe.w_up" in got and "lm_head.weight" in got
    assert "lm_head.bias" not in got and "ernie.blocks.0.qkv.bias" in got


@pytest.mark.parametrize("sparse", [True, False])
def test_logits_and_loss_match_jax(sparse):
    jm = _jax_model(sparse)
    tm = _port_model(_arrays(jm), sparse)
    ids, labels = _batch()
    want_logits = np.asarray(jm(paddle.to_tensor(ids))._data)
    want_loss = float(np.asarray(jm(paddle.to_tensor(ids),
                                    labels=paddle.to_tensor(labels))._data))
    with torch.no_grad():
        logits = tm(ids).numpy()
        loss = float(tm(ids, labels=labels))
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    S = ids.size
    want_mode = "sparse" if sparse else "dense"
    assert all(m.resolve_dispatch(S) == want_mode for m in _moe_layers(tm))


def _jax_train(model, ids, labels):
    mesh_mod.set_mesh(None)
    try:
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        model = jax_fleet.distributed_model(model)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=LR,
                            parameters=model.parameters()),
            strategy=strategy)
        step = opt.make_train_step(model,
                                   lambda m, x, y: m(x, labels=y))
        x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
        losses = [float(step(x, y).numpy()) for _ in range(STEPS)]
        return losses, _arrays(model)
    finally:
        mesh_mod.set_mesh(None)


def test_train_steps_match_jax():
    jm = _jax_model(sparse=True)
    init = _arrays(jm)
    ids, labels = _batch()
    want_losses, want_final = _jax_train(jm, ids, labels)
    tm = fleet.distributed_model(_port_model(init, sparse=True))
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(learning_rate=LR, parameters=tm.parameters()))
    step = opt.make_train_step(tm, lambda m, x, y: m(x, labels=y))
    losses = [float(step(ids, labels)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[2] < losses[0]
    final = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert final.keys() == want_final.keys()
    n = far = 0
    for k in want_final:
        diff = np.abs(final[k] - want_final[k])
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > 1e-5).sum())
        n += diff.size
    assert far <= 1e-3 * n, (far, n)


# ---------------------------------------------------------------------------
# the layers ERNIE adds to the port
# ---------------------------------------------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_layer_norm_matches_jax():
    paddle.seed(0)
    jl = jnn.LayerNorm(24)
    tl = tnn.LayerNorm(24, device="cpu")
    arrays = {"weight": _x((24,), 1), "bias": _x((24,), 2)}
    jl.weight._data = jnp.asarray(arrays["weight"])
    jl.bias._data = jnp.asarray(arrays["bias"])
    load_numpy_state_dict(tl, arrays)
    x = 3.0 * _x((2, 5, 24)) + 1.0
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(paddle.to_tensor(x))._data), **TOL)
    # over two trailing axes, without weight or bias
    np.testing.assert_allclose(
        F.layer_norm(torch.from_numpy(x), (5, 24)).numpy(),
        np.asarray(JF.layer_norm(paddle.to_tensor(x), (5, 24))._data),
        **TOL)


def test_biased_linear_matches_jax_and_bias_attr_false_drops_it():
    paddle.seed(0)
    jl = jnn.Linear(12, 7)
    tl = tnn.Linear(12, 7, device="cpu")
    assert tl.bias is not None and not tl.bias.detach().any()  # zeros
    arrays = {"weight": _x((12, 7), 1), "bias": _x((7,), 2)}
    jl.weight._data = jnp.asarray(arrays["weight"])
    jl.bias._data = jnp.asarray(arrays["bias"])
    load_numpy_state_dict(tl, arrays)
    x = _x((3, 4, 12))
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(paddle.to_tensor(x))._data), **TOL)
    assert set(tnn.Linear(12, 7, bias_attr=False,
                          device="cpu").state_dict()) == {"weight"}


@pytest.mark.parametrize("name,kw", [("gelu", {}),
                                     ("gelu", {"approximate": True}),
                                     ("relu", {}), ("silu", {})])
def test_activations_match_jax(name, kw):
    x = 3.0 * _x((64,))
    np.testing.assert_allclose(
        getattr(F, name)(torch.from_numpy(x), **kw).numpy(),
        np.asarray(getattr(JF, name)(paddle.to_tensor(x), **kw)._data),
        atol=1e-6, rtol=1e-6)


def test_the_two_gelus_differ():
    """F.gelu's default is the exact (erf) form, as in the JAX package;
    the tanh form differs by more than the tolerances above."""
    x = torch.linspace(-4, 4, 81)
    assert (F.gelu(x) - F.gelu(x, approximate=True)).abs().max() > 1e-4


def test_dropout_follows_the_training_flag_and_the_seed():
    d = tnn.Dropout(0.25)
    x = torch.ones(4000)
    pt.seed(5)
    a = d(x)
    kept = a != 0
    assert 0.70 < kept.float().mean() < 0.80
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    pt.seed(5)
    torch.testing.assert_close(d(x), a)            # the seed repeats it
    d.eval()
    assert d(x) is x
    down = tnn.Dropout(0.25, mode="downscale_in_infer")
    assert set(down(x).unique().tolist()) <= {0.0, 1.0}
    down.eval()
    torch.testing.assert_close(down(x), x * 0.75)
    assert F.dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="between 0 and 1"):
        F.dropout(x, 1.5)
    # along an axis: whole rows kept or dropped
    rows = F.dropout(torch.ones(50, 8), 0.5, axis=0)
    assert all(len(r.unique()) == 1 for r in rows)
