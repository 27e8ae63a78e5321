"""The int8 weight's K-major layout, the int8 matmul's variant rule and the
cached ``act_scale`` read of the port's ``Int8Linear``, on the CPU.

- ``ops.int8_matmul._variant``: ``"tc"`` (the tensor cores, ``wgmma`` s8
  fed by TMA) exactly for a K-major wq with K a multiple of 16 and both
  bases 16-byte aligned; ``"mma_sync"`` (the first kernel) for a row-major
  wq, K % 16 != 0 or a base off 16 bytes. Either output dtype.
- ``Int8Linear.qweight`` is ``[in, out]`` with K-major storage (its
  ``.t()`` contiguous) when made, and stays so through ``from_linear``,
  ``Module.to`` and a device copy, ``copy.deepcopy``, ``state_dict``
  through ``torch.save`` / ``torch.load`` and ``load_state_dict``,
  ``load_numpy_state_dict``, ``quantize_model``, PTQ and QAT convert;
  its values stay the JAX package's.
- ``int8_linear`` on the K-major view equals the JAX ``int8_linear`` (its
  Pallas kernel in interpret mode) exactly, and its straight-through dx
  within 1e-6; the quantized tiny Llama's logits equal JAX's within 1e-5
  (fp32 matmuls in another order), as in ``test_torch_quant.py``.
- ``act_scale``: a steady-state forward reads it to the host no time
  (``nn.quant.act_scale_reads`` counts the reads); ``fill_``, ``copy_``,
  ``load_state_dict``, ``load_numpy_state_dict``, a reassigned buffer and
  a device copy each take effect on the next call with one read; a layer
  made under ``torch.inference_mode`` (no version counter) reads it no
  time and still follows every write; every output equals the JAX
  layer's, which reads it every call.
"""
import copy
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import quant as jq
from paddle_tpu.ops.pallas import int8_matmul as jim
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")


def _arrays(jm):
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


def _at(shape, offset, rng):
    """An int8 tensor of ``shape`` whose base lies ``offset`` bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.empty(n + 32, dtype=torch.int8)
    skip = (-buf.data_ptr()) % 16 + offset
    t = buf[skip:skip + n].view(shape)
    t.copy_(torch.from_numpy(rng.integers(-127, 128, shape).astype(
        np.int8)))
    return t


def _k_major(wq):
    """The [K, N] view of a contiguous [N, K] copy of wq."""
    return wq.t().contiguous().t()


def _operands(M, K, N, seed, layout="K-major", x_off=0, w_off=0):
    rng = np.random.default_rng(seed)
    xq = _at((M, K), x_off, rng)
    if layout == "K-major":
        wq = _at((N, K), w_off, rng).t()
    else:
        wq = _at((K, N), w_off, rng)
    xs = torch.from_numpy((rng.random((M, 1)) * 0.02 + 1e-3).astype(
        np.float32))
    ws = torch.from_numpy((rng.random((1, N)) * 0.02 + 1e-3).astype(
        np.float32))
    return xq, xs, wq, ws


def _is_k_major(t):
    return t.dim() == 2 and t.t().is_contiguous() and (
        t.shape[0] == 1 or t.shape[1] == 1 or not t.is_contiguous())


# ---------------------------------------------------------------------------
# the variant rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,layout,x_off,w_off,want", [
    (512, 4096, 4096, "K-major", 0, 0, "tc"),          # q/k/v/o
    (37, 128, 300, "K-major", 0, 0, "tc"),             # tile edges
    (1, 16, 129, "K-major", 0, 0, "tc"),               # K = 16
    (4, 64, 1, "row-major", 0, 0, "tc"),               # N = 1: both at once
    (512, 4096, 4096, "row-major", 0, 0, "mma_sync"),  # n contiguous
    (37, 200, 300, "K-major", 0, 0, "mma_sync"),       # K % 16 = 8
    (5, 8, 16, "K-major", 0, 0, "mma_sync"),           # K < 16
    (37, 128, 300, "K-major", 4, 0, "mma_sync"),       # xq off 16 bytes
    (37, 128, 300, "K-major", 0, 8, "mma_sync"),       # wq off 16 bytes
])
def test_variant_rule(M, K, N, layout, x_off, w_off, want, out_dtype):
    xq, xs, wq, ws = _operands(M, K, N, M + K + N, layout, x_off, w_off)
    assert tim._variant(xq, wq) == want
    # on the CPU every layout takes the plain version, bit for bit the
    # row-major product
    before = dict(tim.int8_matmul_rescale.launches_by_variant)
    got = tim.int8_matmul_rescale(xq, xs, wq, ws, out_dtype=out_dtype)
    assert tim.int8_matmul_rescale.launches_by_variant == before
    want_out = tim.int8_matmul_rescale_reference(xq, xs, wq.contiguous(),
                                                 ws, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got.float(), want_out.float())


def test_layouts_the_kernels_take():
    rng = np.random.default_rng(0)
    wide = _at((64, 96), 0, rng)
    assert tim._k_major(_k_major(wide))
    assert not tim._k_major(wide)
    strided = wide[:, :48]                 # neither layout: the kernels
    assert not (strided.is_contiguous() or tim._k_major(strided))  # raise


def _jax_pair(seed=0):
    paddle.seed(seed)
    jlin = jnn.Linear(128, 40)
    tlin = Linear(128, 40, device="cpu")
    load_numpy_state_dict(tlin, _arrays(jlin))
    return jq.Int8Linear.from_linear(jlin), tq.Int8Linear.from_linear(tlin)


def test_qweight_is_k_major_when_made_and_through_from_linear():
    m = tq.Int8Linear(128, 40, device="cpu")
    assert tuple(m.qweight.shape) == (128, 40) and _is_k_major(m.qweight)
    jl, tl = _jax_pair()
    assert _is_k_major(tl.qweight)
    np.testing.assert_array_equal(tl.qweight.numpy(),
                                  np.asarray(jl.qweight._data))


def test_qweight_stays_k_major_through_copies_and_state_dicts():
    jl, tl = _jax_pair(1)
    want = tl.qweight.clone()
    # Module.to: a dtype leaves the int8 buffer alone; a device move copies
    # every buffer as Module.to(device) does (strides preserved)
    tl.to(torch.float64)
    assert _is_k_major(tl.qweight)
    tl._apply(lambda t: t.to("cpu", copy=True))
    assert _is_k_major(tl.qweight) and torch.equal(tl.qweight, want)
    assert _is_k_major(copy.deepcopy(tl).qweight)
    buf = io.BytesIO()
    torch.save(tl.state_dict(), buf)
    buf.seek(0)
    sd = torch.load(buf)
    assert _is_k_major(sd["qweight"])
    fresh = tq.Int8Linear(128, 40, device="cpu")
    fresh.load_state_dict(sd)
    assert _is_k_major(fresh.qweight) and torch.equal(fresh.qweight, want)
    other = tq.Int8Linear(128, 40, device="cpu")
    load_numpy_state_dict(other, _arrays(jl))
    assert _is_k_major(other.qweight) and torch.equal(other.qweight, want)


def _tiny_pair(seed=0):
    paddle.seed(seed)
    jm = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32"))
    jm.eval()
    tm = LlamaForCausalLM(CFG, device="cpu")
    load_numpy_state_dict(tm, _arrays(jm))
    return jm, tm


def _qweights(tm):
    return {n: m.qweight for n, m in tm.named_modules()
            if isinstance(m, tq.Int8Linear)}


def test_ptq_and_qat_convert_give_k_major_qweights():
    jm, tm = _tiny_pair()
    rng = np.random.default_rng(0)
    calib = [rng.integers(0, CFG.vocab_size, (2, 16)) for _ in range(2)]
    jq.PostTrainingQuantization(jm).quantize(iter(calib))
    tq.PostTrainingQuantization(tm).quantize(iter(calib))
    qw = _qweights(tm)
    assert len(qw) == 15 and all(_is_k_major(w) for w in qw.values())
    want = _arrays(jm)
    for n, w in qw.items():
        np.testing.assert_array_equal(w.numpy(), want[n + ".qweight"])
    _, tm2 = _tiny_pair()
    tq.ImperativeQuantAware().quantize(tm2)
    tq.ImperativeQuantAware.convert(tm2)
    qw2 = _qweights(tm2)
    assert len(qw2) == 15 and all(_is_k_major(w) for w in qw2.values())


# ---------------------------------------------------------------------------
# the K-major view against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_on_the_k_major_view_equals_jax(x_dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[x_dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    ct = rng.standard_normal((2, 3, 72)).astype(np.float32)
    _, _, wq, ws = _operands(1, 128, 72, seed=3)
    assert _is_k_major(wq) and tim._variant(
        torch.zeros(6, 128, dtype=torch.int8), wq) == "tc"
    jx = jnp.asarray(x, jdt)
    want = jim.int8_linear(jx, jnp.asarray(wq.numpy()),
                           jnp.asarray(ws.numpy()), jdt, True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        x_dtype).requires_grad_()
    got = tim.int8_linear(tx, wq, ws, x_dtype)
    assert got.dtype == x_dtype and got.shape == (2, 3, 72)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.array(want.astype(jnp.float32)))
    if x_dtype == torch.float32:        # the straight-through dx
        import jax
        jdx = jax.grad(lambda a: jnp.sum(jim.int8_linear(
            a, jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()),
            jnp.float32, True) * jnp.asarray(ct)))(jnp.asarray(x))
        got.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(
            tx.grad.numpy(), np.asarray(jdx), rtol=1e-6,
            atol=1e-6 * np.abs(np.asarray(jdx)).max())


def test_quantized_tiny_llama_on_k_major_weights_equals_jax():
    jm, tm = _tiny_pair()
    jq.quantize_model(jm)
    tq.quantize_model(tm)
    assert all(_is_k_major(w) for w in _qweights(tm).values())
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.inference_mode():
        got = tm(ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# act_scale: read to the host only when it changed
# ---------------------------------------------------------------------------

def _jax_out(jl, x, act_scale):
    jl.act_scale._data = jnp.asarray(act_scale, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jl(paddle.to_tensor(x))._data)


def _reads():
    return tq.act_scale_reads


def _set_fill(tl, v):
    tl.act_scale.fill_(v)


def _set_copy(tl, v):
    tl.act_scale.copy_(torch.tensor(v))


def _set_load_state_dict(tl, v):
    sd = {k: t.clone() for k, t in tl.state_dict().items()}
    sd["act_scale"] = torch.tensor(v)
    tl.load_state_dict(sd)


def _set_numpy(tl, v):
    arrays = {k: t.numpy() for k, t in tl.state_dict().items()}
    arrays["act_scale"] = np.float32(v)
    load_numpy_state_dict(tl, arrays)


def _set_reassigned(tl, v):
    tl.act_scale = torch.tensor(v, dtype=torch.float32)


def _set_device_copy(tl, v):
    with torch.no_grad():
        tl.act_scale.fill_(v)
    tl._apply(lambda t: t.to("cpu", copy=True))


@pytest.mark.parametrize("change", [_set_fill, _set_copy,
                                    _set_load_state_dict, _set_numpy,
                                    _set_reassigned, _set_device_copy],
                         ids=lambda f: f.__name__[5:])
def test_act_scale_change_takes_effect_on_the_next_call(monkeypatch, change):
    monkeypatch.setenv("PADDLE_TPU_INT8_MXU", "1")
    jl, tl = _jax_pair(2)
    x = np.random.default_rng(3).standard_normal((3, 5, 128)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    for v in (0.02, 0.05, 0.0, 0.03):
        with torch.no_grad():
            change(tl, v)
        n = _reads()
        got = [tl(tx).detach().numpy() for _ in range(3)]
        assert _reads() - n == 1                  # one read, then none
        want = _jax_out(jl, x, v)
        for g in got:
            np.testing.assert_array_equal(g, want)


def test_a_layer_made_under_inference_mode_reads_act_scale_no_time(
        monkeypatch):
    """Inference tensors have no version counter: the QDQ is selected on
    the device every call, so a write is still seen, and the host reads
    nothing."""
    monkeypatch.setenv("PADDLE_TPU_INT8_MXU", "1")
    jl, ref = _jax_pair(4)
    x = np.random.default_rng(5).standard_normal((2, 7, 128)).astype(
        np.float32)
    with torch.inference_mode():
        tl = tq.Int8Linear(128, 40, device="cpu")
        tl.load_state_dict(ref.state_dict())
        assert tl.act_scale.is_inference()
        n = _reads()
        for v in (0.0, 0.02, 0.04):
            tl.act_scale.fill_(v)
            got = tl(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, _jax_out(jl, x, v))
        assert _reads() == n
