"""Optimizers, clipping and LR schedules of the PyTorch port against the
JAX package.

SGD and Momentum (with Nesterov, and with coupled L2 decay), Adam and
AdamW step for step against JAX ``apply_gradients_functional``
over 5 steps, on fp32 and bf16 parameters (the bf16 ones keep an fp32
master copy and fp32 moments); coupled L2 decay (Adam) and decoupled
decay filtered by ``apply_decay_param_fun`` (AdamW, which gets the
parameter's name); ``ClipGradByGlobalNorm`` alone and inside the
update; the eager ``step()`` equal to the functional update;
``LinearWarmup`` and ``CosineAnnealingDecay`` values.

Tolerances: fp32 state within rtol 1e-6 (the same elementwise
arithmetic; the two frameworks may fuse a multiply-add differently);
bf16 parameters within one bf16 ulp (2**-8 relative), since an fp32
master that differs in its last bit may round to the neighbouring bf16.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxGlobalNorm
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.optimizer import lr

SHAPES = {"layer.weight": (6, 5), "norm.weight": (5,), "head.weight": (5, 7)}


def _params(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng):
    return {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(make_jax, make_port, dtype, steps=5, lr_value=1e-2):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jo, to = make_jax(), make_port()
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    refs = {k: types.SimpleNamespace(name=k, is_sparse_table=False)
            for k in SHAPES}
    for _ in range(steps):
        g = _grads(rng)
        jp, js = jo.apply_gradients_functional(
            jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, js,
            jnp.float32(lr_value), params_ref=refs)
        tp, ts = to.apply_gradients_functional(
            tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts,
            lr_value)
    return jp, js, tp, ts


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _assert_match(jp, js, tp, ts, dtype):
    for k in SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
        tol = dict(rtol=2 ** -8, atol=1e-6) if dtype == "bfloat16" else \
            dict(rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **tol, err_msg=k)
        assert set(ts[k]) == set(js[k]), k
        for n in ts[k]:
            np.testing.assert_allclose(_np(ts[k][n]), _np(js[k][n]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k}/{n}")
            if n != "beta1_pow" and n != "beta2_pow":
                want = torch.float32 if (dtype == "float32" or n in (
                    "master", "moment1", "moment2", "velocity")) else torch.bfloat16
                assert ts[k][n].dtype == want, (k, n)
        assert ("master" in ts[k]) == (dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["Adam", "AdamW"])
def test_step_for_step_against_jax(algo, dtype):
    jp, js, tp, ts = _run_both(
        lambda: getattr(jax_optim, algo)(learning_rate=1e-2),
        lambda: getattr(optimizer, algo)(learning_rate=1e-2), dtype)
    _assert_match(jp, js, tp, ts, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo,kw", [
    ("SGD", {}), ("SGD", dict(weight_decay=0.05)), ("Momentum", {}),
    ("Momentum", dict(momentum=0.8, use_nesterov=True)),
    ("Momentum", dict(weight_decay=0.05))])
def test_sgd_and_momentum_step_for_step_against_jax(algo, kw, dtype):
    jp, js, tp, ts = _run_both(
        lambda: getattr(jax_optim, algo)(learning_rate=1e-2, **kw),
        lambda: getattr(optimizer, algo)(learning_rate=1e-2, **kw), dtype)
    _assert_match(jp, js, tp, ts, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_decay_against_jax(dtype):
    keep = (lambda name: "norm" not in name)
    jp, js, tp, ts = _run_both(
        lambda: jax_optim.AdamW(learning_rate=1e-2, weight_decay=0.1,
                                apply_decay_param_fun=keep),
        lambda: optimizer.AdamW(learning_rate=1e-2, weight_decay=0.1,
                                apply_decay_param_fun=keep), dtype)
    _assert_match(jp, js, tp, ts, dtype)
    jp, js, tp, ts = _run_both(
        lambda: jax_optim.Adam(learning_rate=1e-2, weight_decay=0.05),
        lambda: optimizer.Adam(learning_rate=1e-2, weight_decay=0.05), dtype)
    _assert_match(jp, js, tp, ts, dtype)


def test_global_norm_clip_against_jax():
    g = _grads(np.random.default_rng(1))
    g = {k: 30 * v for k, v in g.items()}            # norm well above 1
    want = JaxGlobalNorm(1.0).apply_functional(
        {k: jnp.asarray(v) for k, v in g.items()})
    got = ClipGradByGlobalNorm(1.0).apply_functional(
        {k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    norm = torch.sqrt(sum((v ** 2).sum() for v in got.values()))
    assert abs(norm.item() - 1.0) < 1e-5
    small = ClipGradByGlobalNorm(1e3).apply_functional(
        {k: torch.from_numpy(v) for k, v in g.items()})
    assert all(torch.equal(small[k], torch.from_numpy(g[k])) for k in g)
    by_norm = ClipGradByNorm(0.5).apply_functional(
        {k: torch.from_numpy(v) for k, v in g.items()})
    assert all(abs(v.norm().item() - 0.5) < 1e-5 for v in by_norm.values())
    by_value = ClipGradByValue(0.2)([(None,
                                      torch.from_numpy(g["norm.weight"]))])
    assert by_value[0][1].abs().max() <= 0.2
    jp, js, tp, ts = _run_both(
        lambda: jax_optim.AdamW(learning_rate=1e-2,
                                grad_clip=JaxGlobalNorm(0.05)),
        lambda: optimizer.AdamW(learning_rate=1e-2,
                                grad_clip=ClipGradByGlobalNorm(0.05)),
        "float32")
    _assert_match(jp, js, tp, ts, "float32")


def test_eager_step_equals_the_functional_update():
    rng = np.random.default_rng(2)
    p0, g = _params(rng), _grads(rng)
    params = [(k, torch.nn.Parameter(torch.from_numpy(v).clone()))
              for k, v in p0.items()]
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=params,
                          apply_decay_param_fun=lambda n: "norm" not in n)
    for k, p in params:
        p.grad = torch.from_numpy(g[k])
    opt.step()
    ref = optimizer.AdamW(learning_rate=1e-2,
                          apply_decay_param_fun=lambda n: "norm" not in n)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    want, want_st = ref.apply_gradients_functional(
        tp, {k: torch.from_numpy(v) for k, v in g.items()},
        ref.init_state(tp), 1e-2)
    for k, p in params:
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(opt.state_dict()[k]["moment2"],
                           want_st[k]["moment2"])
    opt.clear_grad()
    assert all(p.grad is None for _, p in params)


def test_lr_schedules_match_jax():
    pairs = [
        (jax_lr.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01),
         lr.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01)),
        (jax_lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1),
         lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)),
        (jax_lr.LinearWarmup(jax_lr.CosineAnnealingDecay(0.1, T_max=5),
                             warmup_steps=3, start_lr=0.01, end_lr=0.1),
         lr.LinearWarmup(lr.CosineAnnealingDecay(0.1, T_max=5),
                         warmup_steps=3, start_lr=0.01, end_lr=0.1)),
    ]
    for want, got in pairs:
        seen = []
        for _ in range(10):
            seen.append((got(), want()))
            got.step()
            want.step()
        np.testing.assert_allclose(*zip(*seen), rtol=1e-12)
    sched = lr.CosineAnnealingDecay(0.1, T_max=7)
    opt = optimizer.AdamW(learning_rate=sched)
    assert opt.get_lr() == sched()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
