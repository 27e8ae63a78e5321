"""Mixed precision in the PyTorch port against the JAX package's.

``paddle_tpu_torch.amp`` (``auto_cast``, ``decorate``, ``GradScaler``),
the train step's ``amp_level=`` / ``scaler=`` and ``strategy.amp``, held
to ``paddle_tpu``'s. Inputs come from numpy seeds; the JAX model's
initial weights carry into the port through ``load_numpy_state_dict``.

Tolerances:
- the cast policy (which tensors are bf16/fp16/fp32) is compared
  exactly: the dtype of q, the attention output, the MLP activation, the
  residual stream and the head's input and output in every layer;
- values of one cast product: within one bf16 (fp16) rounding of the
  same fp32 sum, rtol 2**-7 (2**-10);
- O1/O2 train steps: the products round to bf16 in both packages, but
  XLA rounds the elementwise ops of a bf16 activation op by op where
  PyTorch rounds once, so activations differ by an ulp (2**-8). The
  losses agree within rtol 5e-4 (measured: 2.0e-4 at the third step).
  The parameters are compared through SGD (lr 0.5), where an update is
  linear in the gradient: ``|Δ_port − Δ_jax| / |Δ_jax|`` over all
  parameters within 1e-2 (measured 4.6e-3 on Llama) and per parameter
  within 5e-2 (measured worst 2.5e-2, the small update of an ERNIE
  LayerNorm weight, a sum over many rounded terms); AdamW turns
  rounding-level gradients into full-size steps, so an AdamW run is
  held to its losses;
- the scaler: a skipped step leaves parameters and optimizer state bit
  for bit as they were; scaled and unscaled steps agree within 1e-5 in
  fp32 (JAX's own bound, ``tests/test_train_step_extras.py``).
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu import amp as jax_amp
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.autograd.tape import functional_mode
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.nn import functional as jF
from paddle_tpu.text.models import ernie_moe as jernie
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.text.models import llama as jllama
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp.auto_cast import maybe_cast_compute
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor_ops import matmul
from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY, GPT_TINY,
                                          ErnieMoEForPretraining,
                                          GPTForCausalLM)
from paddle_tpu_torch.text.models import llama as tllama

STEPS = 3
STEP_LAYERS = W.AMP_LAYERS     # the steps' depth: each JAX layer compiles
SGD_LR = 0.5
LOSS_RTOL = 5e-4
UPDATE_RTOL = 1e-2
PARAM_RTOL = 5e-2


def _np(x):
    return np.asarray(x).astype(np.float32)


def _arrays(jax_model):
    return {k: _np(v._data) for k, v in jax_model.state_dict().items()}


def _dt(t):
    return str(t.dtype).replace("torch.", "") if isinstance(
        t, torch.Tensor) else str(np.dtype(t._data.dtype))


def _ids(vocab, shape=(4, 32), seed=123):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the cast policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", [("bfloat16", 2 ** -7),
                                        ("float16", 2 ** -10)])
def test_linear_and_matmul_cast_as_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    with jax_amp.auto_cast(dtype=dtype):
        want = jF.linear(jx, jw, jb)
        want_mm = paddle.matmul(jx, jw)
        want_t = paddle.matmul(jx, paddle.to_tensor(w.T), transpose_y=True)
    with amp.auto_cast(dtype=dtype):
        got = F.linear(tx, tw, tb)
        got_mm = matmul(tx, tw)
        got_t = matmul(tx, torch.from_numpy(w.T.copy()), transpose_y=True)
        assert amp.amp_state()["dtype"] == getattr(torch, dtype)
    assert amp.amp_state() is None
    for g, wnt in ((got, want), (got_mm, want_mm), (got_t, want_t)):
        assert _dt(g) == _dt(wnt) == dtype
        np.testing.assert_allclose(_np(g.float()), _np(wnt._data),
                                   rtol=rtol, atol=rtol)
    # outside auto_cast nothing casts
    assert F.linear(tx, tw, tb).dtype == torch.float32


def test_cast_touches_only_fp32_and_nesting_restores():
    x32 = torch.ones(2, 4)
    xb = torch.ones(2, 4, dtype=torch.bfloat16)
    xi = torch.ones(2, 4, dtype=torch.int64)
    with amp.auto_cast():
        a, b, c, d = maybe_cast_compute(x32, xb, xi, 3.0)
        assert (a.dtype, b.dtype, c.dtype, d) == (
            torch.bfloat16, torch.bfloat16, torch.int64, 3.0)
        assert b is xb and c is xi
        with amp.auto_cast(enable=False):
            assert amp.amp_state() is None
            assert F.linear(x32, torch.ones(4, 3)).dtype == torch.float32
        with amp.auto_cast(dtype="float16", level="O2"):
            assert amp.amp_state() == {"enable": True, "level": "O2",
                                       "dtype": torch.float16}
        assert amp.amp_state()["dtype"] == torch.bfloat16
        # a bf16 input and an fp32 weight: the weight casts, as in JAX
        assert F.linear(xb, torch.ones(4, 3)).dtype == torch.bfloat16
    assert amp.amp_state() is None
    assert amp.amp_guard is amp.auto_cast
    # the same in JAX
    with jax_amp.auto_cast():
        with jax_amp.auto_cast(enable=False):
            assert jax_amp.amp_state() is None
        assert jax_amp.amp_state()["level"] == "O1"
    assert jax_amp.amp_state() is None


# ---------------------------------------------------------------------------
# the dtype trace: the cast policy is the result
# ---------------------------------------------------------------------------

def _traced_forward(run, patches, layers, lm_head):
    """Call ``run()`` (the model's forward and loss under amp) and return
    the dtype trace: q and the attention output of every attention call,
    the activation of every MLP, the residual after every layer, the
    head's input and output (or the fused head's operands) and the
    loss."""
    trace = []

    def wrap_attn(fn):
        def f(q, k, v, *a, **kw):
            out = fn(q, k, v, *a, **kw)
            trace.extend([("q", _dt(q)), ("attn_out", _dt(out))])
            return out
        return f

    def wrap_act(fn):
        def f(x, *a, **kw):
            out = fn(x, *a, **kw)
            trace.append(("act", _dt(out)))
            return out
        return f

    def wrap_fused(fn):
        def f(h, w, *a, **kw):
            trace.extend([("head_in", _dt(h)), ("head_w", _dt(w))])
            return fn(h, w, *a, **kw)
        return f

    undo = []
    for mod, name, wrapper in patches:
        old = getattr(mod, name)
        undo.append((mod, name, old))
        setattr(mod, name, {"attn": wrap_attn, "act": wrap_act,
                            "fused": wrap_fused}[wrapper](old))
    for layer in layers:
        old = layer.forward

        def fwd(*a, _old=old, **kw):
            out = _old(*a, **kw)
            trace.append(("resid", _dt(out)))
            return out
        layer.forward = fwd
    if lm_head is not None:
        old_head = lm_head.forward

        def head(x, _old=old_head):
            out = _old(x)
            trace.extend([("head_in", _dt(x)), ("logits", _dt(out))])
            return out
        lm_head.forward = head
    try:
        trace.append(("loss", run()))
    finally:
        for mod, name, old in undo:
            setattr(mod, name, old)
    return trace


def _jax_llama(**kw):
    paddle.seed(0)
    return jllama.LlamaForCausalLM(dataclasses.replace(
        jllama.LLAMA_TINY, dtype="float32", **kw))


def _port_llama(init, **kw):
    m = tllama.LlamaForCausalLM(dataclasses.replace(
        tllama.LLAMA_TINY, dtype="float32", **kw), device="cpu")
    load_numpy_state_dict(m, init)
    return m


def _one_layer_llama():
    import paddle_tpu_torch as pt
    pt.seed(0)
    return tllama.LlamaForCausalLM(dataclasses.replace(
        tllama.LLAMA_TINY, dtype="float32", num_hidden_layers=1),
        device="cpu")


def _jax_gpt(**kw):
    paddle.seed(0)
    return jgpt.GPTForCausalLM(dataclasses.replace(jgpt.GPT_TINY,
                                                   dropout=0.0, **kw))


def _port_gpt(init, **kw):
    m = GPTForCausalLM(dataclasses.replace(GPT_TINY, dropout=0.0, **kw),
                       device="cpu")
    load_numpy_state_dict(m, init)
    return m


TRACES = {
    # name: (fused_ce_chunk, level, dtype, model family)
    "llama_o1_bf16": (0, "O1", "bfloat16", "llama"),
    "llama_o1_fused_head": (256, "O1", "bfloat16", "llama"),
    "llama_o1_fp16": (0, "O1", "float16", "llama"),
    "llama_o2_bf16": (256, "O2", "bfloat16", "llama"),
    "gpt_o1_bf16": (0, "O1", "bfloat16", "gpt"),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_dtype_trace_matches_jax(name):
    chunk, level, dtype, family = TRACES[name]
    if family == "llama":
        jm = _jax_llama(fused_ce_chunk=chunk)
        tm = _port_llama(_arrays(jm), fused_ce_chunk=chunk)
        jlayers, tlayers = jm.llama.layers, tm.llama.layers
        act = ("silu", jF, torch.nn.functional)
        vocab = tllama.LLAMA_TINY.vocab_size
    else:
        jm = _jax_gpt()
        tm = _port_gpt(_arrays(jm))
        jlayers, tlayers = jm.gpt.blocks, tm.gpt.blocks
        act = ("gelu", jF, F)
        vocab = GPT_TINY.vocab_size
    if level == "O2":
        jax_amp.decorate(jm, level="O2", dtype=dtype)
        amp.decorate(tm, level="O2", dtype=dtype)
    ids = _ids(vocab, (2, 16))

    def jax_run():
        # traced, not run: the dtypes are those of the JAX program
        def f(x):
            with functional_mode(), jax_amp.auto_cast(level=level,
                                                      dtype=dtype):
                return jm(JTensor(x), labels=JTensor(x))._data
        return str(jax.eval_shape(f, ids).dtype)

    def port_run():
        with torch.no_grad(), amp.auto_cast(level=level, dtype=dtype):
            return _dt(tm(ids, labels=ids))

    want = _traced_forward(
        jax_run, [(jF, "scaled_dot_product_attention", "attn"),
                  (act[1], act[0], "act"),
                  (jF, "fused_linear_cross_entropy", "fused")],
        jlayers, None if chunk else jm.lm_head)
    got = _traced_forward(
        port_run, [(F, "scaled_dot_product_attention", "attn"),
                   (act[2], act[0], "act"),
                   (F, "fused_linear_cross_entropy", "fused")],
        tlayers, None if chunk else tm.lm_head)
    assert got == want
    n_layers = len(tlayers)
    assert [k for k, _ in got].count("q") == n_layers
    if level == "O1":
        # the residual stream stays fp32 and the attention runs in the
        # amp dtype
        assert ("resid", "float32") in got and ("q", dtype) in got


# ---------------------------------------------------------------------------
# O1 / O2 train steps against JAX's make_train_step(amp_level=...)
# ---------------------------------------------------------------------------

def _jax_sgd_run(make_model, ids, labels, amp_level=None, use_strategy=False,
                 scaler=None, decorate=None, opt="sgd", masters=False):
    jax_mesh.set_mesh(None)
    try:
        s = jax_fleet.DistributedStrategy()
        s.amp = use_strategy
        jax_fleet.init(is_collective=True, strategy=s)
        model = jax_fleet.distributed_model(make_model())
        init = _arrays(model)
        if decorate:
            jax_amp.decorate(model, level="O2", dtype=decorate)
        o = (jax_optim.SGD(learning_rate=SGD_LR,
                           parameters=model.parameters()) if opt == "sgd"
             else jax_optim.AdamW(learning_rate=1e-3,
                                  parameters=model.parameters()))
        step = jax_fleet.distributed_optimizer(o, strategy=s) \
            .make_train_step(model, lambda m, x, y: m(x, labels=y),
                             amp_level=amp_level, scaler=scaler)
        x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
        losses = [float(step(x, y).numpy()) for _ in range(STEPS)]
        final = ({k: _np(st["master"]) for k, st in step._opt_state.items()}
                 if masters else _arrays(model))
        return init, losses, final
    finally:
        jax_mesh.set_mesh(None)


def _port_run(model, ids, labels, amp_level=None, use_strategy=False,
              scaler=None, opt="sgd", masters=False):
    s = fleet.DistributedStrategy()
    s.amp = use_strategy
    fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(model)
    o = (optimizer.SGD(learning_rate=SGD_LR, parameters=model.parameters())
         if opt == "sgd" else
         optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters()))
    step = fleet.distributed_optimizer(o).make_train_step(
        model, lambda m, x, y: m(x, labels=y), amp_level=amp_level,
        scaler=scaler)
    losses = [float(step(ids, labels)) for _ in range(STEPS)]
    final = ({k: st["master"].numpy() for k, st in
              step.state_dict()["opt"].items()} if masters else
             {k: v.detach().float().numpy()
              for k, v in model.state_dict().items()})
    return step, losses, final


def _assert_updates_close(init, got, want):
    """``|Δ_port − Δ_jax| / |Δ_jax|`` over all parameters within
    ``UPDATE_RTOL``, and per parameter within ``PARAM_RTOL``."""
    assert got.keys() == want.keys()
    num = den = 0.0
    for k in want:
        du = np.linalg.norm(got[k] - want[k])
        u = np.linalg.norm(want[k] - init[k])
        assert u > 0, k
        assert du <= PARAM_RTOL * u, (k, du / u)
        num, den = num + du ** 2, den + u ** 2
    assert num <= UPDATE_RTOL ** 2 * den, np.sqrt(num / den)


def _ernie_ids():
    rng = np.random.default_rng(5)
    return (rng.integers(0, ERNIE_MOE_TINY.vocab_size, (4, 32)).astype(
        np.int32), rng.integers(0, ERNIE_MOE_TINY.vocab_size,
                                (4, 32)).astype(np.int32))


def _models(family):
    if family == "gpt":
        return (lambda: _jax_gpt(num_hidden_layers=STEP_LAYERS),
                lambda init: _port_gpt(init, num_hidden_layers=STEP_LAYERS),
                _ids(1024), None)

    def jm():
        paddle.seed(0)
        return jernie.ErnieMoEForPretraining(dataclasses.replace(
            jernie.ERNIE_MOE_TINY, dropout=0.0))

    def tm(init):
        m = ErnieMoEForPretraining(dataclasses.replace(
            ERNIE_MOE_TINY, dropout=0.0), device="cpu")
        load_numpy_state_dict(m, init)
        return m
    ids, labels = _ernie_ids()
    return jm, tm, ids, labels


def test_o1_llama_step_through_strategy_amp_matches_jax(jax_llama_o1):
    """``strategy.amp`` (O1) with a GradScaler, at world 1."""
    init, want_losses, want, _ = jax_llama_o1
    ids = _ids(1024)
    step, losses, got = _port_run(
        _port_llama(init, num_hidden_layers=STEP_LAYERS), ids, ids,
        use_strategy=True,
        scaler=amp.GradScaler(init_loss_scaling=W.AMP_SCALE))
    assert step.amp_level == "O1"
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _assert_updates_close(init, got, want)
    assert float(step.state_dict()["scaler"]["scale"]) == W.AMP_SCALE
    assert not bool(step.last_found_inf)


# gpt: amp_level="O1"; ernie-moe: amp_level="O1" with a GradScaler
O1_CASES = {"gpt": None, "ernie_moe": 256.0}


@pytest.mark.parametrize("family", list(O1_CASES))
def test_o1_step_matches_jax(family):
    init_scale = O1_CASES[family]
    jm, tm, ids, labels = _models(family)
    labels = ids if labels is None else labels
    jscaler = (jax_amp.GradScaler(init_loss_scaling=init_scale)
               if init_scale else None)
    init, want_losses, want = _jax_sgd_run(jm, ids, labels, amp_level="O1",
                                           scaler=jscaler)
    scaler = amp.GradScaler(init_loss_scaling=init_scale) \
        if init_scale else None
    step, losses, got = _port_run(tm(init), ids, labels, amp_level="O1",
                                  scaler=scaler)
    assert step.amp_level == "O1"
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _assert_updates_close(init, got, want)
    if init_scale:
        assert float(step.state_dict()["scaler"]["scale"]) == init_scale
        assert not bool(step.last_found_inf)


def test_o2_step_after_decorate_matches_jax():
    """``decorate`` casts the fp32 parameters to bf16 in place (the same
    ``Parameter`` objects), SGD keeps fp32 masters; the masters after 3
    O2 steps match JAX's."""
    ids = _ids(1024)
    init, want_losses, want = _jax_sgd_run(
        lambda: _jax_llama(fused_ce_chunk=256, num_hidden_layers=STEP_LAYERS),
        ids, ids, amp_level="O2", decorate="bfloat16", masters=True)
    model = _port_llama(init, fused_ce_chunk=256,
                        num_hidden_layers=STEP_LAYERS)
    before = [id(p) for p in model.parameters()]
    opt_params = optimizer.SGD(learning_rate=SGD_LR,
                               parameters=model.parameters())
    assert amp.decorate(model, level="O2") is model
    m2, o2 = amp.decorate([model], opt_params, level="O2")
    assert m2 == [model] and o2 is opt_params
    assert [id(p) for p in model.parameters()] == before
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    step, losses, got = _port_run(model, ids, ids, amp_level="O2",
                                  masters=True)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    init_bf16 = {k: v.astype(np.float32) for k, v in init.items()}
    init_bf16 = {k: torch.from_numpy(v).bfloat16().float().numpy()
                 for k, v in init_bf16.items()}
    _assert_updates_close(init_bf16, got, want)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_fp16_decorate_with_the_fused_head_names_the_long_tail():
    import paddle_tpu_torch as pt
    pt.seed(0)
    model = tllama.LlamaForCausalLM(dataclasses.replace(
        tllama.LLAMA_TINY, dtype="float32", num_hidden_layers=1,
        fused_ce_chunk=256), device="cpu")
    amp.decorate(model, dtype="float16")
    ids = _ids(1024, (2, 16))
    with pytest.raises(NotImplementedError, match="item 9: long tail"):
        with amp.auto_cast(level="O2", dtype="float16"):
            model(ids, labels=ids)


# ---------------------------------------------------------------------------
# the scaler inside the step: JAX's tests/test_train_step_extras.py:61-125
# ---------------------------------------------------------------------------

class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16, device="cpu")
        self.fc2 = nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _make(accumulate_steps=None, scaler=None, seed=0, lr=1e-2):
    import paddle_tpu_torch as pt
    pt.seed(seed)
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    model = fleet.distributed_model(_MLP())
    opt = fleet.distributed_optimizer(optimizer.Adam(
        learning_rate=lr, parameters=model.parameters()))
    return model, opt.make_train_step(model, _mse,
                                      accumulate_steps=accumulate_steps,
                                      scaler=scaler)


def _snapshot(model, step):
    return ({k: v.detach().clone() for k, v in model.named_parameters()},
            {k: {n: t.clone() for n, t in st.items()}
             for k, st in step.state_dict()["opt"].items()})


@pytest.mark.parametrize("accumulate_steps", [None, 2])
def test_scaler_skips_step_on_inf(accumulate_steps):
    scaler = amp.GradScaler(init_loss_scaling=1024.0, decr_ratio=0.5,
                            incr_every_n_steps=1000,
                            decr_every_n_nan_or_inf=1)
    model, step = _make(accumulate_steps, scaler=scaler,
                        lr=optimizer.lr.LinearWarmup(1e-2, 4, 0.0, 1e-2))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    y = rng.standard_normal((4, 4)).astype(np.float32)
    step(torch.from_numpy(x), torch.from_numpy(y))   # one real update
    params, state = _snapshot(model, step)
    lr_before = step.optimizer.get_lr()
    x[3] = np.inf
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    assert not np.isfinite(float(loss))
    assert bool(step.last_found_inf)
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), params[k]), k
    for k, st in step.state_dict()["opt"].items():
        for n, t in st.items():
            assert torch.equal(t, state[k][n]), (k, n)
    # scale decayed 1024 -> 512; the LR scheduler still stepped
    assert float(step.state_dict()["scaler"]["scale"]) == 512.0
    assert step.optimizer.get_lr() == pytest.approx(lr_before + 2.5e-3)


def test_scaler_good_steps_update_and_grow():
    scaler = amp.GradScaler(init_loss_scaling=8.0, incr_ratio=2.0,
                            incr_every_n_steps=2)
    model, step = _make(scaler=scaler)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    step(x, y)
    assert not bool(step.last_found_inf)
    assert any(not torch.equal(before[k], v.detach())
               for k, v in model.named_parameters())
    step(x, y)
    # 2 good steps with incr_every=2 -> scale 8 -> 16
    assert float(step.state_dict()["scaler"]["scale"]) == 16.0
    assert int(step.state_dict()["scaler"]["good"]) == 0


def test_scaled_update_matches_unscaled():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    m1, s1 = _make()
    s1(x, y)
    m2, s2 = _make(scaler=amp.GradScaler(init_loss_scaling=256.0))
    s2(x, y)
    for (k, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_scaler_state_round_trips_through_the_step():
    scaler = amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=2)
    model, step = _make(scaler=scaler)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    step(x, y)
    sd = step.state_dict()
    snap = {"params": {k: v.clone() for k, v in sd["params"].items()},
            "opt": {k: {n: t.clone() for n, t in st.items()}
                    for k, st in sd["opt"].items()},
            "scaler": {k: v.clone() for k, v in sd["scaler"].items()}}
    assert snap["scaler"]["good"].dtype == torch.int32
    a = [float(step(x, y)) for _ in range(2)]
    grown = float(step.state_dict()["scaler"]["scale"])
    step.load_state_dict(snap)
    assert float(step.state_dict()["scaler"]["scale"]) == 64.0
    assert [float(step(x, y)) for _ in range(2)] == a
    assert float(step.state_dict()["scaler"]["scale"]) == grown == 128.0


# ---------------------------------------------------------------------------
# the eager GradScaler and the rest of the surface
# ---------------------------------------------------------------------------

def test_eager_grad_scaler_matches_jax():
    """scale / backward / step (unscale_, skip on inf) / update over four
    steps, the third with an inf input, against JAX's eager scaler; the
    accessors and both state_dict formats."""
    import paddle_tpu_torch as pt
    from paddle_tpu import nn as jnn

    class JMLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(8, 16)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(jF.relu(self.fc1(x)))

    paddle.seed(0)
    jm = JMLP()
    pt.seed(0)
    tm = _MLP()
    load_numpy_state_dict(tm, _arrays(jm))
    jopt = jax_optim.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=2)
    js, ts = jax_amp.GradScaler(**kw), amp.GradScaler(**kw)
    rng = np.random.default_rng(4)
    for i in range(4):
        x = rng.standard_normal((4, 8)).astype(np.float32)
        if i == 2:
            x[0, 0] = np.inf
        y = rng.standard_normal((4, 4)).astype(np.float32)
        jl = ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        js.scale(jl).backward()
        js.step(jopt)
        js.update()
        jopt.clear_grad()
        tl = _mse(tm, torch.from_numpy(x), torch.from_numpy(y))
        ts.scale(tl).backward()
        ts.step(topt)
        ts.update()
        topt.clear_grad()
        assert ts.state_dict() == js.state_dict(), i
    for k, v in _arrays(jm).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert ts.get_loss_scaling().item() == float(
        np.asarray(js.get_loss_scaling()._data))
    for name, value in (("init_loss_scaling", 4.0), ("incr_ratio", 3.0),
                        ("decr_ratio", 0.25), ("incr_every_n_steps", 7),
                        ("decr_every_n_nan_or_inf", 2)):
        getattr(ts, f"set_{name}")(value)
        getattr(js, f"set_{name}")(value)
        assert getattr(ts, f"get_{name}")() == getattr(js, f"get_{name}")()
    assert ts.state_dict() == js.state_dict()
    fresh = amp.GradScaler()
    fresh.load_state_dict({"scale": 2.0, "good_steps": 1, "bad_steps": 0})
    assert (fresh._scale, fresh._good_steps, fresh._incr_every) == (
        2.0, 1, 1000)
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()
    assert fresh.is_enable() and fresh.is_use_dynamic_loss_scaling()
    off = amp.GradScaler(enable=False)
    assert off.scale(tl) is tl and off.get_init_loss_scaling() == 1.0


def test_strategy_amp_routes_to_o1_and_the_scaler_passes_through():
    model = _one_layer_llama()
    opt = optimizer.AdamW(parameters=model.parameters())
    s = fleet.DistributedStrategy()
    s.amp = True
    fleet.init(is_collective=True, strategy=s)
    assert s.unsupported() == []
    step = fleet.distributed_optimizer(opt, s).make_train_step(
        model, lambda m, x, y: m(x, labels=y))
    assert step.amp_level == "O1" and step.amp_dtype == "bfloat16"
    step = fleet.distributed_optimizer(opt, s).make_train_step(
        model, lambda m, x, y: m(x, labels=y), amp_level="O2")
    assert step.amp_level == "O2"
    scaler = amp.GradScaler()
    assert fleet.distributed_scaler(scaler) is scaler
    wrapped = fleet.HybridParallelGradScaler(scaler)
    assert wrapped.get_init_loss_scaling() == 2.0 ** 15
    step = fleet.make_train_step(model, opt, lambda m, x, y: m(x, labels=y),
                                 scaler=wrapped)
    assert step._scaler_cfg["init"] == 2.0 ** 15
    # a disabled scaler scales nothing, as in JAX
    step = fleet.make_train_step(model, opt, lambda m, x, y: m(x, labels=y),
                                 scaler=amp.GradScaler(enable=False))
    assert step._scaler_cfg is None


def test_group_sharded_parallel_returns_the_scaler():
    from paddle_tpu_torch.distributed import mesh as tmesh
    model = _one_layer_llama()
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    try:
        tmesh.set_mesh(None)
        fleet._strategy = None
        m, opt, sc = group_sharded_parallel(
            model, optimizer.AdamW(parameters=model.parameters()), "os_g",
            scaler=scaler)
        assert sc is scaler
        step = opt.make_train_step(m, lambda mm, x, y: mm(x, labels=y),
                                   scaler=sc, amp_level="O1")
        ids = _ids(1024, (2, 16))
        assert np.isfinite(float(step(ids, ids)))
        assert float(step.state_dict()["scaler"]["scale"]) == 128.0
    finally:
        fleet.init(strategy=fleet.DistributedStrategy())


@pytest.mark.parametrize("mode", ["localsgd", "dgc", "comm_opt"])
def test_amp_beside_a_comm_mode_still_raises(mode):
    model = _one_layer_llama()
    s = fleet.DistributedStrategy()
    s.amp = True
    setattr(s, mode, True)
    with pytest.raises(NotImplementedError, match="strategy.amp"):
        fleet.distributed_optimizer(
            optimizer.SGD(parameters=model.parameters()), s
        ).make_train_step(model, lambda m, x, y: m(x, labels=y))


# ---------------------------------------------------------------------------
# several ranks: dp2 x tp2 under O1 with a scaler, one spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_llama_o1():
    """JAX's single-device O1 step on LLAMA_TINY (fp32 parameters, SGD,
    ``GradScaler(AMP_SCALE)``): 3 steps, then a step whose global batch
    carries an inf (the loss is multiplied by the batch's ``poison``
    mean). Returns (initial weights, losses, weights after 3 steps, what
    the inf step did)."""
    ids = _ids(1024)
    poison = np.ones((4,), np.float32)
    jax_mesh.set_mesh(None)
    try:
        s = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=s)
        model = jax_fleet.distributed_model(
            _jax_llama(num_hidden_layers=STEP_LAYERS))
        init = _arrays(model)
        step = jax_fleet.distributed_optimizer(jax_optim.SGD(
            learning_rate=SGD_LR, parameters=model.parameters()),
            strategy=s).make_train_step(
            model, lambda m, x, y, p: m(x, labels=y) * p.mean(),
            amp_level="O1",
            scaler=jax_amp.GradScaler(init_loss_scaling=W.AMP_SCALE))
        x = paddle.to_tensor(ids)
        losses = [float(step(x, x, paddle.to_tensor(poison)).numpy())
                  for _ in range(STEPS)]
        final = _arrays(model)
        bad = poison.copy()
        bad[3] = np.inf
        step(x, x, paddle.to_tensor(bad))
        after = dict(skipped=bool(np.asarray(step.last_found_inf)),
                     scale=float(np.asarray(step._scaler_state["scale"])),
                     unchanged=all(np.array_equal(v, final[k]) for k, v
                                   in _arrays(model).items()))
    finally:
        jax_mesh.set_mesh(None)
    return init, losses, final, after


@pytest.fixture(scope="module")
def amp_ranks(jax_llama_o1, tmp_path_factory):
    """The port's dp2 x tp2 ranks on gloo from the same weights and batch,
    the inf planted in rank 1's loss only."""
    out = tmp_path_factory.mktemp("amp")
    np.savez(out / "init.npz", **jax_llama_o1[0])
    np.save(out / "ids.npy", _ids(1024))
    dist.spawn(W.amp_worker, args=(str(out), str(out / "init.npz"),
                                   str(out / "ids.npy")),
               nprocs=4, timeout=300)
    ranks = []
    for r in range(4):
        with open(out / f"amp.r{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def test_dp2_tp2_o1_with_a_scaler_matches_jax(jax_llama_o1, amp_ranks):
    init, want_losses, want, _ = jax_llama_o1
    for r in amp_ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=LOSS_RTOL)
        assert r["losses"] == amp_ranks[0]["losses"]
    _assert_updates_close(init, amp_ranks[0]["params"], want)


def test_an_inf_on_one_rank_skips_every_rank(jax_llama_o1, amp_ranks):
    assert jax_llama_o1[3] == dict(skipped=True, scale=W.AMP_SCALE / 2,
                                   unchanged=True)
    for r in amp_ranks:
        assert r["local_inf"] == (r["rank"] == 1)
        assert r["found_inf"] and r["unchanged"]
        assert r["scale_after"] == W.AMP_SCALE / 2
        assert r["scale_before"] == W.AMP_SCALE
