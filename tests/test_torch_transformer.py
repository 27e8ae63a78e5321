"""Attention dropout, explicit masks and the Transformer layers of the
PyTorch port against the JAX package's.

- ``_plain_sdpa`` fed the JAX package's own keep mask
  (``jax.random.bernoulli(key, 1 - p, [B, H, Lq, Lk])``) equals
  ``_xla_sdpa(..., dropout_key=key)``, outputs and the gradients of q, k
  and v through ``jax.vjp``: GQA, causal, a bool and an additive mask,
  cross attention. fp32, the same arithmetic in another summation order:
  within 1e-6 absolute and relative.
- The public ``scaled_dot_product_attention``: training dropout keeps
  each probability with chance 1 - p (within 6 binomial sigmas), draws
  from ``framework.random_seed`` (``seed(n)`` repeats it), and a call
  without mask and dropout (``training=False``) takes ``sdpa_raw``;
  ``attention_path()`` says which.
- ``nn.MultiHeadAttention``, ``TransformerEncoder(Layer)``,
  ``TransformerDecoder(Layer)`` and ``Transformer`` in eval, fp32, the
  JAX layers' weights carried across: within 1e-5, with and without
  masks; incremental decoding through ``Cache`` / ``StaticCache`` too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.autograd.tape import functional_mode
from paddle_tpu.nn.functional.attention import _xla_sdpa
from paddle_tpu.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import _plain_sdpa

SDPA_TOL = dict(rtol=1e-6, atol=1e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, NHEAD, FFN = 32, 4, 64


def _np(x):
    return np.asarray(getattr(x, "_data", x)).astype(np.float32)


def _jax_call(fn, *args):
    """``fn`` on JAX Tensors made from ``args`` (arrays, or pytrees of
    them such as caches, or None), traced once under ``jax.jit``: the JAX
    layers' eager ops would each compile on their own. Returns arrays in
    the structure ``fn`` returns."""
    def wrap(tree):
        return jax.tree_util.tree_map(JTensor, tree)

    def f(*xs):
        with functional_mode():
            out = fn(*(wrap(x) for x in xs))
        return jax.tree_util.tree_map(
            lambda t: t._data if isinstance(t, JTensor) else t, out,
            is_leaf=lambda t: isinstance(t, JTensor))
    return jax.jit(f)(*args)


# ---------------------------------------------------------------------------
# the plain composite fed JAX's keep mask
# ---------------------------------------------------------------------------

# B, Lq, Lk, Hq, Hkv, D, causal, mask, p
SDPA_CASES = {
    "gqa_causal": (2, 16, 16, 4, 2, 8, True, None, 0.2),
    "gqa_bool_mask": (2, 16, 16, 4, 2, 8, False, "bool", 0.1),
    "additive_mask_cross": (2, 8, 16, 4, 4, 8, False, "float", 0.3),
}


def _sdpa_inputs(B, Lq, Lk, Hq, Hkv, D, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, Hkv, D)).astype(np.float32)
    ct = rng.standard_normal((B, Lq, Hq, D)).astype(np.float32)
    mask = None
    if mask_kind == "bool":
        mask = rng.random((B, 1, Lq, Lk)) < 0.7
        mask[..., 0] = True            # every row sees a key
    elif mask_kind == "float":
        mask = rng.standard_normal((B, Hq, Lq, Lk)).astype(np.float32)
        mask[..., -3:] = -1e9
    return q, k, v, ct, mask


@pytest.mark.parametrize("name", list(SDPA_CASES))
def test_plain_sdpa_with_jax_keep_mask_matches_xla_sdpa(name):
    B, Lq, Lk, Hq, Hkv, D, causal, mask_kind, p = SDPA_CASES[name]
    q, k, v, ct, mask = _sdpa_inputs(B, Lq, Lk, Hq, Hkv, D, mask_kind)
    key = jax.random.PRNGKey(7)
    jmask = None if mask is None else jnp.asarray(mask)

    def jf(q, k, v):
        return _xla_sdpa(q, k, v, mask=jmask, causal=causal, dropout_p=p,
                         dropout_key=key)

    @jax.jit
    def fwd_bwd(q, k, v, ct):
        out, vjp = jax.vjp(jf, q, k, v)
        # the keep mask _xla_sdpa draws, drawn again from the same key
        return out, vjp(ct), jax.random.bernoulli(key, 1.0 - p,
                                                  (B, Hq, Lq, Lk))

    want, want_grads, keep = fwd_bwd(q, k, v, ct)
    keep = torch.from_numpy(np.array(keep)) if p > 0 else None
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = _plain_sdpa(tq, tk, tv, causal=causal,
                      mask=None if mask is None else torch.from_numpy(mask),
                      dropout_p=p, _keep=keep)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **SDPA_TOL)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), _np(w), **SDPA_TOL)


# ---------------------------------------------------------------------------
# the public path: keep rate, seed, routing
# ---------------------------------------------------------------------------

def _one_hot_values(B=2, L=64, H=2, p=0.3):
    """q = k = 0 makes every probability 1 / L; v[j] = e_j makes
    ``out[..., j] = keep_j / (L (1 - p))``: the keep mask, readable."""
    q = torch.zeros(B, L, H, L)
    v = torch.eye(L)[None, :, None, :].expand(B, L, H, L).contiguous()
    return q, q.clone(), v


def test_training_dropout_keep_rate_seed_and_routing():
    p = 0.3
    q, k, v = _one_hot_values(p=p)
    pt.seed(11)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=p)
    assert F.attention_path()["path"] == "plain"
    assert "dropout_p=0.3" in F.attention_path()["reason"]
    keep = out * (64 * (1 - p))
    assert torch.allclose(keep, keep.round(), atol=1e-5)
    n = keep.numel()
    rate = float(keep.mean())
    assert abs(rate - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n), rate
    pt.seed(11)
    again = F.scaled_dot_product_attention(q, k, v, dropout_p=p)
    assert torch.equal(again, out)
    pt.seed(12)
    assert not torch.equal(F.scaled_dot_product_attention(
        q, k, v, dropout_p=p), out)
    # outside training: no dropout, sdpa_raw (the flash route on CUDA)
    from paddle_tpu_torch.nn.functional.attention import sdpa_raw
    ev = F.scaled_dot_product_attention(q, k, v, dropout_p=p,
                                        training=False)
    assert F.attention_path()["reason"].startswith("ineligible")
    assert torch.equal(ev, sdpa_raw(q, k, v))
    # a mask takes the plain composite too
    F.scaled_dot_product_attention(q, k, v,
                                   attn_mask=torch.ones(64, 64).bool())
    assert F.attention_path() == {
        "path": "plain",
        "reason": "attn_mask: the plain composite, as in the JAX package"}


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _carry(jax_layer, port_layer):
    jax_layer.eval()
    load_numpy_state_dict(port_layer, {
        k: _np(v._data) for k, v in jax_layer.state_dict().items()})
    return port_layer.eval()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _masks(B, Lq, Lk):
    rng = np.random.default_rng(3)
    boolean = rng.random((B, Lq, Lk)) < 0.8
    boolean[..., 0] = True
    additive = np.where(rng.random((B, NHEAD, Lq, Lk)) < 0.8, 0.0,
                        -1e9).astype(np.float32)
    return {"none": None, "bool3d": boolean, "additive4d": additive}


@pytest.mark.parametrize("mask", ["none", "bool3d", "additive4d"])
def test_multi_head_attention_matches_jax(mask):
    paddle.seed(0)
    jm = jnn.MultiHeadAttention(D_MODEL, NHEAD, dropout=0.1, kdim=24,
                                vdim=20, need_weights=True)
    tm = _carry(jm, nn.MultiHeadAttention(D_MODEL, NHEAD, dropout=0.1,
                                          kdim=24, vdim=20,
                                          need_weights=True, device="cpu"))
    q, key, val = _x((2, 8, D_MODEL), 0), _x((2, 12, 24), 1), _x(
        (2, 12, 20), 2)
    m = _masks(2, 8, 12)[mask]
    want, wnone = _jax_call(lambda *a: jm(*a), q, key, val, m)
    with torch.no_grad():
        got, gnone = tm(*(torch.from_numpy(a) for a in (q, key, val)),
                        attn_mask=None if m is None else torch.from_numpy(m))
    assert wnone is None and gnone is None
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_jax(normalize_before):
    paddle.seed(0)
    jl = jnn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.1,
                                     activation="gelu",
                                     normalize_before=normalize_before)
    jenc = jnn.TransformerEncoder(jl, 2, norm=jnn.LayerNorm(D_MODEL)
                                  if normalize_before else None)
    tl = nn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.1,
                                    activation="gelu",
                                    normalize_before=normalize_before,
                                    device="cpu")
    tenc = _carry(jenc, nn.TransformerEncoder(
        tl, 2, norm=nn.LayerNorm(D_MODEL, device="cpu")
        if normalize_before else None))
    src = _x((2, 10, D_MODEL), 4)
    for m in _masks(2, 10, 10).values():
        want = _jax_call(jenc, src, m)
        with torch.no_grad():
            got = tenc(torch.from_numpy(src),
                       None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)


def test_transformer_and_decoder_match_jax():
    paddle.seed(0)
    jt = jnn.Transformer(D_MODEL, NHEAD, 2, 2, FFN, dropout=0.1)
    tt = _carry(jt, nn.Transformer(D_MODEL, NHEAD, 2, 2, FFN, dropout=0.1,
                                   device="cpu"))
    src, tgt = _x((2, 10, D_MODEL), 5), _x((2, 6, D_MODEL), 6)
    jmask = jnn.Transformer.generate_square_subsequent_mask(6)
    tmask = nn.Transformer.generate_square_subsequent_mask(6)
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    mem_mask = _masks(2, 6, 10)["bool3d"]
    want = _jax_call(lambda s, t, tm, mm: jt(s, t, tgt_mask=tm,
                                             memory_mask=mm),
                     src, tgt, jmask._data, mem_mask)
    with torch.no_grad():
        got = tt(torch.from_numpy(src), torch.from_numpy(tgt),
                 tgt_mask=tmask, memory_mask=torch.from_numpy(mem_mask))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
    assert dict(tt.named_parameters()).keys() == {
        k for k in jt.state_dict()}


def test_incremental_decoding_with_caches_matches_jax():
    """``TransformerDecoder.gen_cache`` (a ``Cache`` per layer for self
    attention, a ``StaticCache`` of the memory for cross attention), fed
    one position at a time: each step's output and the grown caches equal
    JAX's; and the last step equals the full causal decode's last row."""
    paddle.seed(0)
    jl = jnn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0)
    jdec = jnn.TransformerDecoder(jl, 2)
    tdec = _carry(jdec, nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0,
                                   device="cpu"), 2))
    mem, tgt = _x((2, 10, D_MODEL), 7), _x((2, 4, D_MODEL), 8)
    tmem = torch.from_numpy(mem)
    jc, tc = _jax_call(jdec.gen_cache, mem), tdec.gen_cache(tmem)
    assert isinstance(tc[0][0], nn.MultiHeadAttention.Cache)
    assert isinstance(tc[0][1], nn.MultiHeadAttention.StaticCache)
    for t in range(tgt.shape[1]):
        want, jc = _jax_call(lambda x, m, c: jdec(x, m, cache=c),
                             tgt[:, t:t + 1], mem, jc)
        with torch.no_grad():
            got, tc = tdec(torch.from_numpy(tgt[:, t:t + 1]), tmem, cache=tc)
        np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
    for (ti, ts), (ji, js) in zip(tc, jc):
        assert ti.k.shape == (2, tgt.shape[1], NHEAD, D_MODEL // NHEAD)
        for a, b in ((ti.k, ji.k), (ti.v, ji.v), (ts.k, js.k),
                     (ts.v, js.v)):
            np.testing.assert_allclose(a.detach().numpy(), _np(b),
                                       **LAYER_TOL)
    with torch.no_grad():
        full = tdec(torch.from_numpy(tgt), tmem,
                    tgt_mask=nn.Transformer.generate_square_subsequent_mask(
                        tgt.shape[1]))
    np.testing.assert_allclose(full[:, -1:].numpy(), got.numpy(),
                               **LAYER_TOL)
    # a MultiHeadAttention on its own: Cache grows, StaticCache stays
    mha = tdec.layers[0].self_attn
    c = mha.gen_cache(torch.from_numpy(tgt))
    assert c.k.shape == (2, 0, NHEAD, D_MODEL // NHEAD)
    with torch.no_grad():
        _, c = mha(torch.from_numpy(tgt[:, :2]), cache=c)
        st = mha.gen_cache(tmem, type=nn.MultiHeadAttention.StaticCache)
        out = mha(torch.from_numpy(tgt[:, :2]), cache=st)
    assert c.k.shape[1] == 2 and isinstance(out, torch.Tensor)
