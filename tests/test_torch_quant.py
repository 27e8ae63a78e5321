"""The port's weight-only int8 quantization and stochastic rounding against
the JAX package's ``nn.quant``.

- ``quantize_int8`` / ``dequantize_int8``: int8 values and scales exactly
  equal, for fp32 and bf16 weights and both axes.
- ``Int8Linear``: each ``PADDLE_TPU_INT8_MXU`` route (``0``, ``1``,
  ``auto``) against the JAX layer's same route, with and without a
  calibrated ``act_scale`` and a bias. The int8 route (the Pallas kernel
  under ``pltpu.force_tpu_interpret_mode()`` on the JAX side) is exact;
  the dequant route is an fp32 matmul summed in another order (rtol 1e-5,
  atol 1e-6). The bf16 dequantized weight is exactly equal.
- ``quantize_model`` on ``LLAMA_TINY`` (fp32, JAX weights carried
  across): the same swapped layers, state-dict keys and int8 buffers; the
  logits and the dense-CE loss within 1e-5 (fp32 matmuls in another
  order). The untied head runs through the swapped ``lm_head``.
- Stochastic rounding: the port's threefry2x32 bit for bit against
  ``jax.extend.random.threefry_2x32``; the plain versions with all-zero
  words exactly equal to the JAX functions run under
  ``pltpu.force_tpu_interpret_mode()`` (where the TPU generator returns
  zeros), edge values included; with real words the statistical
  properties (each bound derived in ``_stats``), and the dtype gating.
"""
import dataclasses

import jax.extend.random as jer
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import quant as jq
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.ops import stochastic_round as tsr
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32)) \
        if jnp.asarray(a).dtype == jnp.bfloat16 else np.array(a)


def _arrays(jm):
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


# ---------------------------------------------------------------------------
# quantize_int8, Int8Linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_equals_jax(dtype, axis):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                         # an all-zero column: scale 1e-10
    w[7, :] = 0.0
    jw = jnp.asarray(w, jnp.dtype(dtype))
    tw = torch.from_numpy(_np(jw)).to(getattr(torch, dtype))
    jqw, js = jq.quantize_int8(jw, axis=axis)
    q, s = tq.quantize_int8(tw, axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dt in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            tq.dequantize_int8(q, s, dt).float().numpy(),
            _np(jq.dequantize_int8(jqw, js, dt)))


def _int8_pair(bias, act_scale, seed=0):
    paddle.seed(seed)
    jl = jq.Int8Linear.from_linear(jnn.Linear(128, 40,
                                              bias_attr=None if bias
                                              else False))
    if bias:       # a non-zero bias, so that adding it is checked
        jl.bias._data = jnp.asarray(np.random.default_rng(
            seed).standard_normal(40).astype(np.float32))
    jl.act_scale._data = jnp.asarray(act_scale, jnp.float32)
    tl = tq.Int8Linear(128, 40, bias=bias, device="cpu")
    load_numpy_state_dict(tl, _arrays(jl))
    return jl, tl


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act_scale", [0.0, 0.02])
@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_int8_linear_routes_equal_jax(monkeypatch, mode, act_scale, bias):
    jl, tl = _int8_pair(bias, act_scale)
    assert tl.qweight.dtype == torch.int8 and tl.act_scale.shape == ()
    x = np.random.default_rng(1).standard_normal((3, 5, 128)).astype(
        np.float32)
    monkeypatch.setenv("PADDLE_TPU_INT8_MXU", mode)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jl(paddle.to_tensor(x))._data)
    before = tim.int8_matmul_rescale.launches
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert tim.int8_matmul_rescale.launches == before     # CPU: no kernel
    if mode == "1":
        np.testing.assert_array_equal(got, want)
    else:       # "auto" on a CPU input takes the dequant route, as in JAX
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_int8_linear_bf16_dequantized_weight_equals_jax(monkeypatch):
    jl, tl = _int8_pair(False, 0.0)
    want = jl.qweight._data.astype(jnp.bfloat16) * jl.scale._data.astype(
        jnp.bfloat16)
    got = tl.qweight.to(torch.bfloat16) * tl.scale.to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    # and the bf16 forward of both routes runs in bf16
    x = torch.randn(2, 128).to(torch.bfloat16)
    for mode in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_INT8_MXU", mode)
        assert tl(x).dtype == torch.bfloat16


def test_from_linear_honours_an_explicit_scale():
    paddle.seed(2)
    jlin = jnn.Linear(32, 16)
    s = np.full((16,), 0.01, np.float32)
    jl = jq.Int8Linear.from_linear(jlin, scale=s)
    from paddle_tpu_torch.nn import Linear
    tlin = Linear(32, 16, device="cpu")
    load_numpy_state_dict(tlin, _arrays(jlin))
    tl = tq.Int8Linear.from_linear(tlin, scale=s)
    np.testing.assert_array_equal(tl.qweight.numpy(),
                                  np.asarray(jl.qweight._data))
    np.testing.assert_array_equal(tl.scale.numpy(),
                                  np.asarray(jl.scale._data))
    np.testing.assert_array_equal(tl.bias.detach().numpy(),
                                  np.asarray(jl.bias._data))


# ---------------------------------------------------------------------------
# quantize_model on LLAMA_TINY; the untied head
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, port model) with the same fp32 weights, both
    quantized with quantize_model."""
    paddle.seed(0)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, _arrays(jm))
    jq.quantize_model(jm)
    tq.quantize_model(tm)
    return jm, tm


def test_quantize_model_swaps_the_same_layers(tiny_pair):
    jm, tm = tiny_pair
    jnames = sorted(n for n, m in jm.named_sublayers()
                    if isinstance(m, jq.Int8Linear))
    tnames = sorted(n for n, m in tm.named_modules()
                    if isinstance(m, tq.Int8Linear))
    assert tnames == jnames and len(tnames) == 7 * 2 + 1   # + the head
    assert set(tm.state_dict()) == set(jm.state_dict())
    want = _arrays(jm)
    for k, v in tm.state_dict().items():
        if k.endswith((".qweight", ".scale", ".act_scale")):
            assert v.dtype == {"qweight": torch.int8}.get(
                k.rsplit(".", 1)[1], torch.float32), k
            np.testing.assert_array_equal(v.numpy(), want[k])


def test_quantized_llama_logits_and_loss_equal_jax(tiny_pair):
    """Fails without the head repair: the port applied the untied head as
    ``hidden @ lm_head.weight``, and an Int8Linear has no ``weight``."""
    jm, tm = tiny_pair
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 24))
    jids = paddle.to_tensor(ids.astype(np.int32))
    want = np.asarray(jm(jids)._data)
    with torch.inference_mode():
        got = tm(ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want_loss = float(jm(jids, labels=jids).numpy())
    with torch.inference_mode():
        got_loss = float(tm(ids, labels=ids))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


def test_quantize_model_include_filter_and_bare_linear():
    tm = LlamaForCausalLM(dataclasses.replace(CFG, num_hidden_layers=1),
                          device="cpu")
    tq.quantize_model(tm, include=["mlp"])
    swapped = sorted(n for n, m in tm.named_modules()
                     if isinstance(m, tq.Int8Linear))
    assert swapped == ["llama.layers.0.mlp.down_proj",
                       "llama.layers.0.mlp.gate_proj",
                       "llama.layers.0.mlp.up_proj"]
    from paddle_tpu_torch.nn import Linear
    with pytest.raises(TypeError, match="bare Linear"):
        tq.quantize_model(Linear(4, 4, device="cpu"))


def test_jit_save_waits_for_the_long_tail():
    from paddle_tpu_torch import jit
    with pytest.raises(NotImplementedError, match="item 9"):
        jit.save(None, "model")


# ---------------------------------------------------------------------------
# threefry and the stochastic quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [(0, 0), (0, 7), (0xFFFFFFFF, 0x12345678),
                                 (3, 0xFFFFFFFF)])
def test_threefry_is_bit_exact_against_jax(key):
    rng = np.random.default_rng(key[1] & 0xFFFF)
    x = rng.integers(0, 2 ** 32, (2, 1000), dtype=np.uint64)
    x[:, :3] = [[0, 0xFFFFFFFF, 1], [0, 0xFFFFFFFF, 0]]
    # jax splits an even-length count into its two halves (x0, x1) and
    # returns the two output words the same way
    want = np.asarray(jer.threefry_2x32(
        (jnp.uint32(key[0]), jnp.uint32(key[1])),
        jnp.asarray(x.reshape(-1).astype(np.uint32))))
    y0, y1 = tsr.threefry2x32(key[0], key[1],
                              torch.from_numpy(x[0].astype(np.int64)),
                              torch.from_numpy(x[1].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_random_bits_follow_the_documented_counter():
    w = tsr.random_bits(7, 9)
    p = torch.arange(5)
    y0, y1 = tsr.threefry2x32(0, 7, p, torch.zeros_like(p))
    assert torch.equal(w[0::2], y0) and torch.equal(w[1::2], y1[:4])
    assert tsr.seed_key(2 ** 33 + 5) == (2, 5)
    assert not torch.equal(tsr.random_bits(8, 9), w)


def _edge_input():
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(
        np.float32)
    bits = np.array([0x00000000, 0x80000000,           # +0, -0
                     0x00000001, 0x807FFFFF,           # subnormals
                     0x3F80FFFF, 0xBF80FFFF,           # low 16 bits 0xFFFF
                     0x7F7FFFFF, 0xFF7FFFFF,           # +-FLT_MAX
                     0x3F808000, 0x40490FDB], np.uint32)
    x.reshape(-1)[:bits.size] = bits.view(np.float32)
    return x


def _zero_words(x):
    return torch.zeros(x.size, dtype=torch.int64)


def test_stochastic_round_zero_words_equal_jax():
    x = _edge_input()
    with pltpu.force_tpu_interpret_mode():
        want = jq.stochastic_round(jnp.asarray(x), seed=7)
        want8 = jq.stochastic_round(jnp.asarray(x), seed=8)
    np.testing.assert_array_equal(_np(want), _np(want8))   # no random bits
    got = tsr.stochastic_round_bf16_reference(torch.from_numpy(x),
                                              _zero_words(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("case", ["edges", "amax", "zeros"])
def test_quantize_int8_stochastic_zero_words_equal_jax(case):
    x = np.random.default_rng(4).standard_normal((8, 128)).astype(
        np.float32)
    if case == "edges":
        x = _edge_input()
        x[np.abs(x) > 1e30] = 0.0         # keep the scale finite
    elif case == "amax":
        x[0, 0], x[1, 1] = 5.0, -5.0      # +-amax -> +-127
    else:
        x[:] = 0.0                        # scale 1e-10, q = 0
    with pltpu.force_tpu_interpret_mode():
        jqv, jsv = jq.quantize_int8_stochastic(jnp.asarray(x), seed=7)
    q, s = tsr.quantize_int8_stochastic_reference(torch.from_numpy(x),
                                                  _zero_words(x))
    assert q.dtype == torch.int8 and s.shape == (1, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    if case == "amax":
        assert {int(q[0, 0]), int(q[1, 1])} <= {126, 127, -127}
    if case == "zeros":
        assert s.item() == np.float32(1e-10) and not q.any()


def _stats(x, out_bits, q=None, s=None):
    """Round-up share against the mean dropped fraction over n draws: the
    per-element difference (up - frac) has mean 0 and variance at most
    1/4, so |mean| stays below 6 * 0.5 / sqrt(n) (a 6-sigma bound)."""
    n = x.numel()
    if q is None:            # bf16: out_bits are the 16 kept bits
        xb = x.view(torch.int32).long() & 0xFFFFFFFF
        lo = xb >> 16
        up = (out_bits != lo).double()
        frac = (xb & 0xFFFF).double() / 65536.0
        assert bool(((out_bits == lo) | (out_bits == lo + 1)).all())
    else:
        t = x.double() / s.double()
        up = (q.double() > torch.floor(t)).double()
        frac = t - torch.floor(t)
        assert bool(((q.double() - torch.floor(t)).abs() <= 1).all())
    return abs((up - frac).mean().item()), 6 * 0.5 / n ** 0.5


def test_stochastic_plain_versions_are_unbiased():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1024, 1024)).astype(np.float32))
    out = tsr.stochastic_round_bf16(x, seed=11)          # CPU: plain version
    bits = out.view(torch.int16).long() & 0xFFFF
    dev, bound = _stats(x, bits)
    assert dev < bound, (dev, bound)
    # a truncating rounder (u = 0) must fail the same check
    zero = torch.zeros(x.numel(), dtype=torch.long)
    trunc = tsr.stochastic_round_bf16_reference(x, zero)
    assert _stats(x, trunc.view(torch.int16).long() & 0xFFFF)[0] > bound

    q, s = tsr.quantize_int8_stochastic(x, seed=12)
    assert bool(((q.float() * s - x).abs() < s).all())
    dev, bound = _stats(x, None, q, s)
    assert dev < bound, (dev, bound)
    qt, st = tsr.quantize_int8_stochastic_reference(x, zero)
    assert _stats(x, None, qt, st)[0] > bound
    # the mean of q * s over 64 seeds approaches x: per element its
    # spread is at most s / 16, so 0.5 s is an 8-sigma bound
    small = x[:128, :128].contiguous()
    acc = torch.zeros_like(small, dtype=torch.float64)
    for seed in range(64):
        qq, ss = tsr.quantize_int8_stochastic(small, seed=seed)
        acc += qq.double() * ss.double()
    mean = acc / 64
    sc = ss.double().item()
    assert bool(((mean - small.double()).abs() < 0.5 * sc).all())
    assert abs(((mean - small.double()) / sc).mean().item()) < \
        6 * 0.5 / (64 * small.numel()) ** 0.5


def test_stochastic_functions_gate_like_jax():
    x = torch.randn(4, 8)
    out = tq.stochastic_round(x, seed=3)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 8)
    assert torch.equal(out.view(torch.int16),
                       tq.stochastic_round(x, "bfloat16", 3).view(
                           torch.int16))
    for bad in (torch.float16, "int8", torch.float32):
        with pytest.raises(ValueError, match="unsupported"):
            tq.stochastic_round(x, bad)
    for fp8 in (torch.float8_e5m2, "float8_e4m3fn", "float8_e4m3b11fnuz"):
        with pytest.raises(NotImplementedError, match="bf16"):
            tq.stochastic_round(x, fp8)
    with pytest.raises(ValueError, match="2-D"):
        tq.stochastic_round(torch.randn(8))
    q, s = tq.quantize_int8_stochastic(x, seed=1)
    assert q.dtype == torch.int8 and s.shape == (1, 1)
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_int8_stochastic(torch.randn(2, 2, 2))
    assert tq.MOSAIC_SR_TARGETS == jq.MOSAIC_SR_TARGETS
