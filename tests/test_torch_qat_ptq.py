"""QAT, PTQ and AdaRound of the port against the JAX package's
``nn.quant.qat`` / ``nn.quant.adaround``.

- Fake quantization: values and straight-through gradients of the three
  observers against ``jax.grad`` (the moving-average scale with momentum
  0 and 0.9), the scale kept differentiable as in the JAX compiled step;
  observer buffers update in training and freeze in eval.
- PTQ (``abs_max``, ``avg``) on ``LLAMA_TINY`` (fp32, JAX weights carried
  across), two calibration batches: the activation ranges within 1e-6
  relative (fp32 activations computed in another reduction order),
  ``qweight`` and ``scale`` identical, ``act_scale`` within 1e-6.
- QAT: the block (``QuantizedLinear`` with a moving-average observer
  whose scale cuts values) against ``jax.value_and_grad`` under the JAX
  train step's functional mode: output, every gradient and the new scale
  within 1e-6. On ``LLAMA_TINY``, one forward and backward and 2 AdamW
  steps through ``fleet`` against the JAX train step: activations differ
  by fp32 reduction order, and one that close to a rounding boundary of
  its QDQ grid rounds the other way (one LSB apart) and spreads, so the
  whole model is held to the looser limits stated in each test, and the
  first flips must sit at a rounding boundary. ``convert`` of the
  JAX-trained weights gives identical ``Int8Linear`` buffers.
- AdaRound: ``adaround_weight`` at 30 iterations; the learned alpha
  within 2e-2 (mean 2e-3): Adam moves every alpha by about lr = 1e-2 a
  step, and the first steps follow the sign of gradients that are
  rounding noise (the soft rounding starts at the weight itself); at
  most 0.5% of the roundings flipped. The PTQ round trip and the pinned
  grid as in the JAX tests.
- Conv2D waits for the port's Conv2D and raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.autograd.tape import functional_mode
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.jit.api import _swap_params
from paddle_tpu.nn import quant as jq
from paddle_tpu.nn.quant import adaround as jada
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.nn.quant import adaround as tada
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")
LR = 1e-3


def _arrays(jm):
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


def _batch(seed=123, shape=(4, 32)):
    return np.random.default_rng(seed).integers(
        0, LLAMA_TINY.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# fake quantization
# ---------------------------------------------------------------------------

def test_qdq_values_and_ste_gradient_equal_jax():
    x = np.asarray([-3.0, -1.01, -0.5, 0.0, 0.49, 0.9, 2.5], np.float32)
    scale = np.float32(1.0 / 127)
    want = np.asarray(jq.fake_quant_dequant(jnp.asarray(x), scale))
    want_g = np.asarray(jax.grad(lambda a: jq.fake_quant_dequant(
        a, scale).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = tq.fake_quant_dequant(tx, scale)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want_g)
    np.testing.assert_array_equal(tx.grad.numpy(), [0, 0, 1, 1, 1, 1, 0])


@pytest.mark.parametrize("observer", ["abs_max", "channel_wise",
                                      "moving_average_0", "moving_average_9"])
def test_observer_values_and_gradients_equal_jax(observer):
    """The scale stays in the graph on both sides: jax.grad through the
    JAX observer's functional body and torch autograd through the port's
    module give the same gradient, including the share that reaches the
    abs-max element through a clip bound that cuts values."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    ct = rng.standard_normal((16, 24)).astype(np.float32)
    if observer == "abs_max":
        jo, to = jq.FakeQuantAbsMax(), tq.FakeQuantAbsMax()
    elif observer == "channel_wise":
        jo = jq.FakeQuantChannelWiseAbsMax(quant_axis=-1)
        to = tq.FakeQuantChannelWiseAbsMax(quant_axis=-1)
    else:
        mom = 0.0 if observer.endswith("_0") else 0.9
        jo = jq.FakeQuantMovingAverageAbsMax(momentum=mom)
        to = tq.FakeQuantMovingAverageAbsMax(momentum=mom)
        prev = np.float32(0.013)          # a scale that cuts the largest
        jo.scale._data = jnp.asarray(prev)
        jo.initialized._data = jnp.asarray(1.0, jnp.float32)
        to.scale.fill_(float(prev))
        to.initialized.fill_(1.0)
        jo.train()
        to.train()

    def jf(a):
        # the observers read x's raw value: a tracer here, as in the JAX
        # compiled step, so the gradient reaches the scale
        with functional_mode(), _swap_params(dict(jo.named_buffers()), {
                k: b._data for k, b in jo.named_buffers()}):
            out = jo(paddle.Tensor(a))
            new = {k: b._data for k, b in jo.named_buffers()}
        return jnp.sum(out._data * jnp.asarray(ct)), (out._data, new)

    (_, (want, new)), want_g = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = to(tx)
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)
    if observer.startswith("moving"):
        np.testing.assert_allclose(to.scale.item(),
                                   float(np.asarray(new["scale"])),
                                   rtol=1e-6)


def test_moving_average_observer_updates_and_freezes():
    obs = tq.FakeQuantMovingAverageAbsMax(momentum=0.5)
    obs.train()
    obs(torch.tensor([127.0]))
    assert obs.scale.item() == pytest.approx(1.0, rel=1e-6)  # amax at first
    assert obs.initialized.item() == 1.0
    obs(torch.tensor([0.0]))
    s2 = obs.scale.item()
    assert s2 == pytest.approx(0.5, rel=1e-6)                 # EMA
    obs.eval()
    obs(torch.tensor([1000.0]))
    assert obs.scale.item() == s2                             # frozen


def test_qat_convert_matches_fake_quant_eval():
    """QuantizedLinear's eval forward and the converted Int8Linear share
    the per-channel grid; the activation QDQ of the QAT path is the only
    difference (bounded by one activation LSB)."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                                torch.nn.ReLU(), Linear(32, 4, device="cpu"))
    tq.ImperativeQuantAware().quantize(model)
    assert isinstance(model[0], tq.QuantizedLinear)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 16)).astype(np.float32))
    model.train()
    model(x)
    model.eval()
    with torch.no_grad():
        y_qat = model(x)
        tq.ImperativeQuantAware.convert(model)
        assert isinstance(model[0], tq.Int8Linear)
        y_int8 = model(x)
    assert (y_int8 - y_qat).abs().max().item() < 0.1


def test_conv2d_waits_for_the_port_conv():
    with pytest.raises(NotImplementedError, match="item 9"):
        tq.QuantizedConv2D(None)
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 3),
                                torch.nn.Flatten(), Linear(8, 4,
                                                           device="cpu"))
    with pytest.raises(NotImplementedError, match="item 9"):
        tq.ImperativeQuantAware().quantize(model)
    with pytest.raises(NotImplementedError, match="item 9"):
        tq.PostTrainingQuantization(model).quantize([torch.zeros(1, 1, 4,
                                                                 4)])


# ---------------------------------------------------------------------------
# PTQ on LLAMA_TINY
# ---------------------------------------------------------------------------

def _tiny_pair(seed=0):
    paddle.seed(seed)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, _arrays(jm))
    return jm, tm


@pytest.mark.parametrize("algo", ["abs_max", "avg"])
def test_ptq_ranges_and_buffers_equal_jax(algo):
    jm, tm = _tiny_pair()
    calib = [_batch(s, (2, 24)) for s in (1, 2)]
    jptq = jq.PostTrainingQuantization(jm, algo=algo)
    jptq.quantize(iter(calib))
    tptq = tq.PostTrainingQuantization(tm, algo=algo)
    tptq.quantize(iter(calib))
    want, got = jptq.activation_ranges, tptq.activation_ranges
    assert sorted(got) == sorted(want) and len(got) == 15
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    ws = _arrays(jm)
    assert set(tm.state_dict()) == set(ws)
    for k, v in tm.state_dict().items():
        if k.endswith((".qweight", ".scale")):
            np.testing.assert_array_equal(v.numpy(), ws[k])
        elif k.endswith(".act_scale"):
            assert v.item() > 0
            np.testing.assert_allclose(v.numpy(), ws[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# QAT on LLAMA_TINY
# ---------------------------------------------------------------------------

def _jax_qat_grads(jm, ids):
    """Loss, gradients and updated buffers of one forward and backward of
    the JAX QAT model, through jax.value_and_grad in the functional mode
    the JAX train step compiles."""
    params = dict(jm.named_parameters())
    bufs = dict(jm.named_buffers())
    jids = jnp.asarray(ids)

    def loss_of(pv, bv):
        with functional_mode(), _swap_params(params, pv), \
                _swap_params(bufs, bv):
            loss = jm(paddle.Tensor(jids), labels=paddle.Tensor(jids))
            new = {k: b._data for k, b in bufs.items()}
        return loss._data.astype(jnp.float32), new

    pv = {k: p._data for k, p in params.items()}
    bv = {k: b._data for k, b in bufs.items()}
    (loss, new_bufs), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(pv, bv)
    return (float(loss), {k: np.asarray(g) for k, g in grads.items()},
            {k: np.asarray(b) for k, b in new_bufs.items()})


def test_quantized_linear_forward_backward_equals_jax():
    """The QAT block alone, on the same input: output, dx, dW, db and the
    observer's new scale within 1e-6 (fp32 sums in another order). The
    moving-average scale starts below the input's range, so the clip cuts
    values and part of the gradient reaches the abs-max through it."""
    paddle.seed(3)
    jl = jq.QuantizedLinear(jnn.Linear(64, 32))
    tl = tq.QuantizedLinear(Linear(64, 32, device="cpu"))
    load_numpy_state_dict(tl, _arrays(jl))
    for o in (jl.act_fake_quant, tl.act_fake_quant):
        o.train()
    jl.act_fake_quant.scale._data = jnp.asarray(0.02, jnp.float32)
    jl.act_fake_quant.initialized._data = jnp.asarray(1.0, jnp.float32)
    tl.act_fake_quant.scale.fill_(0.02)
    tl.act_fake_quant.initialized.fill_(1.0)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    ct = rng.standard_normal((12, 32)).astype(np.float32)
    params = dict(jl.named_parameters())
    bufs = dict(jl.named_buffers())

    def jf(pv, a):
        with functional_mode(), _swap_params(params, pv), \
                _swap_params(bufs, {k: b._data for k, b in bufs.items()}):
            out = jl(paddle.Tensor(a))._data
            new = {k: b._data for k, b in bufs.items()}
        return jnp.sum(out * jnp.asarray(ct)), (out, new)

    (_, (want, new)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(
        {k: p._data for k, p in params.items()}, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = tl(tx)
    (y * torch.from_numpy(ct)).sum().backward()
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **close)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **close)
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]),
                                   err_msg=k, **close)
    np.testing.assert_allclose(tl.act_fake_quant.scale.item(),
                               float(new["act_fake_quant.scale"]), rtol=1e-6)


def _flips(jm, tm, ids):
    """Activation QDQ codes that differ between the two models' training
    forwards, per QuantizedLinear in forward order (each side's input
    quantized on the JAX observer's grid)."""
    jin, tin = {}, {}
    hooks = []
    for n, m in jm.named_sublayers():
        if isinstance(m, jq.QuantizedLinear):
            m.register_forward_pre_hook(
                lambda l, i, n=n: jin.__setitem__(n, np.asarray(i[0]._data)))
    for n, m in tm.named_modules():
        if isinstance(m, tq.QuantizedLinear):
            hooks.append(m.register_forward_pre_hook(
                lambda l, i, n=n: tin.__setitem__(n, i[0].detach().numpy())))
    jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    tm(ids, labels=ids)
    for h in hooks:
        h.remove()
    out = {}
    for n, m in jm.named_sublayers():
        if n in jin:
            s = float(np.asarray(m.act_fake_quant.scale._data))
            code = lambda a: np.round(np.clip(a, -127 * s, 127 * s) / s)
            out[n] = (int((code(jin[n]) != code(tin[n])).sum()),
                      np.abs(jin[n] / s - np.round(jin[n] / s)))
    return out


def test_qat_llama_forward_backward_tracks_jax():
    """The whole QAT model: its activations differ from the JAX model's
    by fp32 reduction order (~1e-7), and an activation that close to a
    rounding boundary of its QDQ grid rounds the other way, one LSB (~1%
    of its range) apart. At this batch one element of layer 0's MLP input
    does, and the flip spreads through the later layers. So the loss is
    held to 1e-3, each gradient to 5e-2 in relative norm and the observer
    scales to 2e-2; the first flips must sit at a rounding boundary, and
    every block's QDQ decisions before them must agree exactly (the block
    itself is held to 1e-6 above)."""
    jm, tm = _tiny_pair()
    jq.ImperativeQuantAware().quantize(jm)
    tq.ImperativeQuantAware().quantize(tm)
    assert set(tm.state_dict()) == set(jm.state_dict())
    jm.train()
    tm.train()
    ids = _batch()
    loss, grads, bufs = _jax_qat_grads(jm, ids)
    tloss = tm(ids, labels=ids)
    tloss.backward()
    assert tloss.item() == pytest.approx(loss, rel=1e-3)
    tgrads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tgrads.keys() == grads.keys()
    for k, g in grads.items():
        rel = np.linalg.norm(tgrads[k] - g) / np.linalg.norm(g)
        assert rel < 5e-2, (k, rel)
    tb = {k: b.numpy() for k, b in tm.named_buffers()}
    assert tb.keys() == bufs.keys()
    for k, b in bufs.items():
        np.testing.assert_allclose(tb[k], b, rtol=2e-2, err_msg=k)
    # the flips: none before the first site that has any, and those at a
    # rounding boundary (the JAX activation within 1e-4 of an x.5 code)
    first = True
    for n, (count, dist) in _flips(jm, tm, ids).items():
        if count and first:
            assert count <= 2, (n, count)
            assert np.sort(np.abs(dist.ravel() - 0.5))[count - 1] < 1e-4
            first = False
    assert not first


@pytest.fixture(scope="module")
def qat_runs():
    """(initial weights, losses, final weights) of 2 QAT AdamW steps in
    the JAX train step, and the port's from the same initial weights."""
    mesh_mod.set_mesh(None)
    try:
        paddle.seed(0)
        strategy = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=strategy)
        jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
        jq.ImperativeQuantAware().quantize(jm)
        jm = jax_fleet.distributed_model(jm)
        init = _arrays(jm)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=LR, parameters=jm.parameters()),
            strategy=strategy)
        step = opt.make_train_step(jm, lambda m, a, b: m(a, labels=b))
        ids = paddle.to_tensor(_batch())
        jlosses = [float(step(ids, ids).numpy()) for _ in range(2)]
        jfinal = _arrays(jm)
    finally:
        mesh_mod.set_mesh(None)
    tm = LlamaForCausalLM(CFG, device="cpu")
    tq.ImperativeQuantAware().quantize(tm)
    tm = fleet.distributed_model(tm)
    load_numpy_state_dict(tm, init)
    tm.train()
    topt = fleet.distributed_optimizer(
        optimizer.AdamW(learning_rate=LR, parameters=tm.parameters()))
    tstep = topt.make_train_step(tm, lambda m, a, b: m(a, labels=b))
    tlosses = [float(tstep(_batch(), _batch())) for _ in range(2)]
    tfinal = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    return jlosses, jfinal, tlosses, tfinal


def test_qat_train_steps_track_jax(qat_runs):
    """2 AdamW steps: the losses within 1e-3 and the observer scales
    within 2e-2 (the rounding flips above); the parameters within 6 * lr
    everywhere (Adam's first updates are ``lr * sign(g)``, and a gradient
    at noise level or moved by a flip can change sign) and within 0.1 *
    lr on average per tensor."""
    jlosses, jfinal, tlosses, tfinal = qat_runs
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert tlosses[1] < tlosses[0]
    assert tfinal.keys() == jfinal.keys()
    for k, want in jfinal.items():
        if k.endswith((".scale", ".initialized")):        # observers
            np.testing.assert_allclose(tfinal[k], want, rtol=2e-2,
                                       err_msg=k)
            continue
        diff = np.abs(tfinal[k] - want)
        assert diff.max() <= 6 * LR, (k, diff.max())
        assert diff.mean() <= 0.1 * LR, (k, diff.mean())


def test_qat_convert_of_carried_weights_gives_identical_buffers(qat_runs):
    _, jfinal, _, _ = qat_runs
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jq.ImperativeQuantAware().quantize(jm)
    for k, v in jm.state_dict().items():
        v._data = jnp.asarray(jfinal[k])
    tm = LlamaForCausalLM(CFG, device="cpu")
    tq.ImperativeQuantAware().quantize(tm)
    load_numpy_state_dict(tm, jfinal)
    jq.ImperativeQuantAware.convert(jm)
    tq.ImperativeQuantAware.convert(tm)
    want = _arrays(jm)
    got = tm.state_dict()
    assert set(got) == set(want)
    assert sum(k.endswith(".qweight") for k in got) == 15
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # the converted model runs its head through the swapped lm_head
    assert isinstance(tm.lm_head, tq.Int8Linear)
    with torch.inference_mode():
        assert torch.isfinite(tm(_batch(5, (1, 8)))).all()


# ---------------------------------------------------------------------------
# AdaRound
# ---------------------------------------------------------------------------

def _last_alpha(module, monkeypatch):
    """Record the argument of the module's last ``_soft_rounding`` call:
    the final alpha, at the hard-rounding step."""
    seen = {}
    orig = module._soft_rounding

    def spy(alpha):
        seen["alpha"] = alpha
        return orig(alpha)

    monkeypatch.setattr(module, "_soft_rounding", spy)
    return seen


def test_adaround_weight_equals_jax(monkeypatch):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    x = rng.normal(size=(256, 32)).astype(np.float32)
    s = np.asarray(jq.quantize_int8(jnp.asarray(w), axis=0)[1])
    ja = _last_alpha(jada, monkeypatch)
    want = np.asarray(jada.adaround_weight(w, x, s, num_iterations=30))
    ta = _last_alpha(tada, monkeypatch)
    got = tada.adaround_weight(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(s), num_iterations=30)
    dalpha = np.abs(ta["alpha"].numpy() - np.asarray(ja["alpha"]))
    assert dalpha.max() < 2e-2 and dalpha.mean() < 2e-3, dalpha.max()
    flipped = np.mean(np.round(got.numpy() / s) != np.round(want / s))
    assert flipped <= 0.005, flipped
    ints = got.numpy() / s
    assert np.abs(ints - np.round(ints)).max() < 1e-4     # on the grid


def test_ptq_round_type_adaround_end_to_end():
    torch.manual_seed(0)
    model = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                                torch.nn.ReLU(), Linear(32, 8, device="cpu"))
    rng = np.random.default_rng(1)
    calib = [torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
             for _ in range(4)]
    with torch.no_grad():
        ref = model(calib[0])
    q = tq.PostTrainingQuantization(model, round_type="adaround").quantize(
        calib, max_batches=4)
    assert isinstance(q[0], tq.Int8Linear) and q[0].act_scale.item() > 0
    with torch.no_grad():
        out = q(calib[0])
    assert torch.isfinite(out).all()
    rel = (out - ref).abs().mean() / (ref.abs().mean() + 1e-6)
    assert rel < 0.25, rel


def test_adaround_scale_pinned_through_from_linear():
    lin = Linear(16, 8, device="cpu")
    rng = np.random.default_rng(2)
    calib = [torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))]
    tq.run_adaround(calib, lin, num_iterations=50)
    assert hasattr(lin, "_adaround_scale")
    q = tq.Int8Linear.from_linear(lin)
    np.testing.assert_array_equal(q.scale.numpy().ravel(),
                                  lin._adaround_scale.numpy().ravel())
    deq = q.qweight.float() * q.scale
    np.testing.assert_allclose(deq.numpy(), lin.weight.detach().numpy(),
                               atol=1e-6)
