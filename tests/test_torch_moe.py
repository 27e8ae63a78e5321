"""MoE routing and ``MoELayer`` of the PyTorch port against the JAX
package (``paddle_tpu/nn/moe.py``).

The same fp32 logits through ``_topk_gating_sparse`` give exactly the
same integers (``e_flat``, ``sort_idx``, ``starts``, ``counts``,
``slot``) and the same weights, keep mask and aux loss; ``_topk_gating``
the same dispatch and combine tensors. A ``MoELayer`` with the JAX
layer's weights carried across gives the same output, aux loss and
gradients (input, gate and both expert banks) under dense dispatch,
sparse dispatch with the einsum experts, and sparse dispatch with the
ragged kernel's path (its plain version on the CPU); also with a
``SwitchGate`` (k=1) and with capacity drops. The experts' GELU is the
tanh form of ``jax.nn.gelu``'s default, which a dedicated test tells
apart from the exact form.

Tolerance: fp32, the same arithmetic in another order: 1e-6 for the
routing floats, 1e-5 for layer outputs and gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import moe as jmoe
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)


def _logits(S, E, seed):
    return np.random.default_rng(seed).standard_normal((S, E)).astype(
        np.float32)


@pytest.mark.parametrize("k,capacity", [(2, 5), (2, 100), (1, 4), (3, 7)])
def test_sparse_routing_matches_jax(k, capacity):
    logits = _logits(24, 4, seed=k + capacity)
    want = jmoe._topk_gating_sparse(jnp.asarray(logits), k, capacity)
    got = tmoe._topk_gating_sparse(torch.from_numpy(logits), k, capacity)
    names = ("e_flat", "sort_idx", "starts", "counts", "slot", "weight",
             "keep", "aux")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("e_flat", "sort_idx", "starts", "counts", "slot"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6,
                                       err_msg=name)
    if capacity == 5:                       # the case really drops tokens
        assert float(got[6].min()) == 0.0


@pytest.mark.parametrize("k,capacity", [(2, 5), (1, 100)])
def test_dense_routing_matches_jax(k, capacity):
    logits = _logits(20, 4, seed=10 + k)
    want = jmoe._topk_gating(jnp.asarray(logits), k, capacity)
    got = tmoe._topk_gating(torch.from_numpy(logits), k, capacity)
    for name, g, w in zip(("dispatch", "combine", "aux"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


def _pair(dispatch, kernel, switch=False, capacity_factor=1.25, d=16,
          f=32, E=4, scale_up=1.0):
    """(jax layer, port layer) with the same weights."""
    paddle.seed(0)
    kw = dict(dispatch_mode=dispatch, expert_kernel=kernel,
              capacity_factor=capacity_factor)
    if switch:
        jm = jmoe.MoELayer(d, f, E, gate=jmoe.SwitchGate(d, E,
                                                         capacity_factor),
                           **kw)
        tm = tmoe.MoELayer(d, f, E, gate=tmoe.SwitchGate(
            d, E, capacity_factor, device="cpu"), device="cpu", **kw)
    else:
        jm = jmoe.MoELayer(d, f, E, k=2, **kw)
        tm = tmoe.MoELayer(d, f, E, k=2, device="cpu", **kw)
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    arrays["w_up"] = arrays["w_up"] * scale_up
    jm.w_up._data = jnp.asarray(arrays["w_up"])
    load_numpy_state_dict(tm, arrays)
    return jm, tm


def _jax_run(jm, x, cot):
    xj = paddle.to_tensor(x, stop_gradient=False)
    out = jm(xj)
    loss = (out * paddle.to_tensor(cot)).sum() + 0.01 * jm.aux_loss
    loss.backward()
    grads = {"x": xj.grad, "w_up": jm.w_up.grad, "w_down": jm.w_down.grad,
             "gate": jm.gate.weight.grad}
    return (np.asarray(out._data), float(np.asarray(jm.aux_loss._data)),
            {k: np.asarray(v._data) for k, v in grads.items()})


def _port_run(tm, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    loss = (out * torch.from_numpy(cot)).sum() + 0.01 * tm.aux_loss
    loss.backward()
    grads = {"x": xt.grad, "w_up": tm.w_up.grad, "w_down": tm.w_down.grad,
             "gate": tm.gate.weight.grad}
    return (out.detach().numpy(), float(tm.aux_loss.detach()),
            {k: v.numpy() for k, v in grads.items()})


@pytest.mark.parametrize("dispatch,kernel,switch,cf", [
    ("dense", "einsum", False, 1.25),
    ("sparse", "einsum", False, 1.25),
    ("sparse", "ragged", False, 1.25),
    ("sparse", "ragged", False, 0.5),       # capacity drops
    ("dense", "einsum", False, 0.5),
    ("sparse", "ragged", True, 1.25),       # SwitchGate, k = 1
    ("dense", "einsum", True, 1.25),
])
def test_moe_layer_forward_and_grads_match_jax(dispatch, kernel, switch, cf):
    jm, tm = _pair(dispatch, kernel, switch=switch, capacity_factor=cf)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 16)).astype(np.float32)
    want_out, want_aux, want_g = _jax_run(jm, x, cot)
    out, aux, g = _port_run(tm, x, cot)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    for name in want_g:
        np.testing.assert_allclose(g[name], want_g[name], **TOL,
                                   err_msg=name)


def test_auto_dispatch_follows_the_jax_rule():
    tm = tmoe.MoELayer(16, 32, 8, k=2, device="cpu")
    for S in (16, 1024, 8192):
        C = tm.gate.capacity(S)
        assert C == jmoe.TopKGate(16, 8).capacity(S)
        want = ("dense" if S * 8 * C <= jmoe.MoELayer.DENSE_DISPATCH_LIMIT
                else "sparse")
        assert tm.resolve_dispatch(S) == want
    assert tm.resolve_dispatch(8192) == "sparse"      # bench.py's ERNIE
    assert tm.gate.capacity(8192) == 2560


def test_expert_kernel_default_follows_the_environment(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_MOE_RAGGED", raising=False)
    assert tmoe.MoELayer(8, 16, 2, device="cpu").expert_kernel == "einsum"
    monkeypatch.setenv("PADDLE_TPU_MOE_RAGGED", "1")
    assert tmoe.MoELayer(8, 16, 2, device="cpu").expert_kernel == "ragged"
    with pytest.raises(ValueError, match="expert_kernel"):
        tmoe.MoELayer(8, 16, 2, expert_kernel="dense", device="cpu")


def test_moe_gelu_is_the_tanh_form():
    """With up-projection weights large enough that the experts'
    pre-activations reach |x| ~ 2 (where the two GELUs differ by ~5e-4),
    the port matches the JAX layer, and the same layer with the exact
    GELU would not."""
    jm, tm = _pair("sparse", "ragged", scale_up=30.0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        tm._act = lambda h: torch.nn.functional.gelu(h)   # the exact form
        exact = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(exact - want).max() > 1e-4
    h = np.linspace(-4, 4, 81).astype(np.float32)
    np.testing.assert_allclose(
        tmoe.MoELayer(8, 16, 2, device="cpu")._act(
            torch.from_numpy(h)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h))), atol=1e-6)
