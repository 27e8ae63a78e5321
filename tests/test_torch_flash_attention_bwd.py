"""Flash-attention backward of the PyTorch port against the JAX package.

On CPU tensors the port's backward wrappers run their plain versions
(``flash_attention_bwd_dq_reference``, ``flash_attention_bwd_dkv_
reference``); their dq, dk and dv must agree with the JAX package's
Pallas ``_bwd`` (interpret mode) from the same forward ``(out, lse)``:
causal and full, GQA, lengths that are not a multiple of the block,
``Lq < Lk``, and ``Lq > Lk`` whose first causal rows see no key (zero
gradients there, never NaN). The autograd Function around the kernels
(``flash_attention_fn``) matches ``jax.vjp`` of the JAX flash attention,
and the port's ``F.scaled_dot_product_attention`` matches ``jax.grad`` of
``_xla_sdpa``. The CUDA kernels are held against the plain versions by
the ``gpu``-marked tests and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _xla_sdpa
from paddle_tpu.ops.pallas.flash_attention import _bwd as jax_bwd
from paddle_tpu.ops.pallas.flash_attention import _fwd as jax_fwd
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

# fp32: the same arithmetic in another reduction order; gradients sum
# over up to Lq * Lk terms, hence the looser rtol than the forward's
TOL = dict(atol=1e-5, rtol=1e-4)

CASES = [
    (1, 32, 32, 4, 4, 16, 16, True),   # MHA, L a multiple of the block
    (2, 40, 40, 4, 2, 16, 16, True),   # GQA, L not a multiple of the block
    (1, 24, 56, 4, 1, 8, 16, True),    # Lq < Lk (bottom-right causal)
    (1, 40, 24, 2, 2, 8, 8, True),     # Lq > Lk: the first rows see nothing
    (1, 40, 24, 2, 2, 8, 8, False),    # the same, full attention
]


def _inputs(rng, B, Lq, Lk, Hq, Hkv, D):
    mk = (lambda *s: rng.standard_normal(s).astype(np.float32))
    return mk(B, Lq, Hq, D), mk(B, Lk, Hkv, D), mk(B, Lk, Hkv, D), \
        mk(B, Lq, Hq, D)


def _sw(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,block,causal", CASES)
def test_plain_backward_matches_jax_bwd(B, Lq, Lk, Hq, Hkv, D, block,
                                        causal):
    q, k, v, do = _inputs(np.random.default_rng(0), B, Lq, Lk, Hq, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    # jitted: the interpreted grid runs as one compiled loop
    out, lse = jax.jit(lambda a, b, c: jax_fwd(
        a, b, c, causal, scale, block, block, True))(_sw(q), _sw(k), _sw(v))
    want = jax.jit(lambda a, b, c, o, l, d: jax_bwd(
        a, b, c, o, l, d, causal, scale, block, block, True))(
        _sw(q), _sw(k), _sw(v), out, lse, _sw(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tout, tlse = fa.flash_attention(*t[:3], causal=causal)
    got = fa.flash_attention_backward(*t[:3], tout, tlse, t[3],
                                      causal=causal)
    for name, g, x, w in zip(("dq", "dk", "dv"), got, t, want):
        assert g.shape == x.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(_sw(w)), **TOL,
                                   err_msg=name)


def test_fully_masked_rows_get_zero_grads_not_nan():
    B, Lq, Lk, Hq, Hkv, D = 1, 40, 24, 2, 1, 8
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        np.random.default_rng(1), B, Lq, Lk, Hq, Hkv, D))
    out, lse = fa.flash_attention(q, k, v, causal=True)
    blind = Lq - Lk                       # rows 0..15 see no key
    assert (lse[:, :, :blind] == fa.MASK_VALUE).all()
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, do,
                                             causal=True)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert (dq[:, :blind] == 0).all() and (dq[:, blind:] != 0).any()


def test_autograd_function_matches_jax_flash_vjp():
    causal = True
    q, k, v, do = _inputs(np.random.default_rng(2), 2, 40, 40, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def fwd_vjp(a, b, c, g):
        out, vjp = jax.vjp(
            lambda x, y, z: jax_flash(x, y, z, causal=causal, block_q=16,
                                      block_k=16, interpret=True), a, b, c)
        return out, vjp(g)

    want_out, want = jax.jit(fwd_vjp)(jq, jk, jv, jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention_fn(*t, causal=causal)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_sdpa_grads_match_jax_grad_of_xla_sdpa():
    """On the CPU the port's functional takes the plain composite; its
    autograd gradients are those of the JAX package's ``_xla_sdpa``."""
    q, k, v, do = _inputs(np.random.default_rng(3), 2, 48, 48, 4, 2, 16)
    _, vjp = jax.vjp(lambda a, b, c: _xla_sdpa(a, b, c, causal=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*t, is_causal=True)
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_expanded_grad_output_is_accepted():
    """autograd may hand the backward an expanded dO (stride 0 in the
    head dim): the wrapper copies it to a contiguous one."""
    q, k, v, _ = _inputs(np.random.default_rng(4), 1, 16, 16, 2, 2, 8)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.flash_attention_fn(*t, causal=True).sum().backward()
    ones = torch.ones(1, 16, 2, 8)
    out, lse = fa.flash_attention(*[x.detach() for x in t], causal=True)
    want = fa.flash_attention_backward_reference(
        *[x.detach() for x in t], out, lse, ones, causal=True)
    for x, w in zip(t, want):
        torch.testing.assert_close(x.grad, w, atol=1e-6, rtol=1e-6)


def _bf16(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16)


def test_bwd_variant_rule_main_path_bf16_takes_the_tensor_cores():
    """``_bwd_variant`` reads dtype, strides, alignment and head dim only,
    so it runs on CPU tensors: the trainers' bf16 operands (Llama D = 128,
    ERNIE-MoE D = 64, and D = 32) take the tensor cores."""
    llama = _bf16(2, 2048, 32, 128)                 # Llama-2-7B trainer
    assert fa._bwd_variant(llama, llama, llama, llama) == "tc"
    ernie = _bf16(8, 1024, 16, 64)
    assert fa._bwd_variant(ernie, ernie, ernie, ernie) == "tc"
    small = _bf16(1, 200, 4, 32)
    assert fa._bwd_variant(small, small, small, small) == "tc"
    gqa = _bf16(1, 512, 8, 128)                      # GQA group 4
    q = llama[:1, :512]
    assert fa._bwd_variant(q, gqa, gqa, q.contiguous()) == "tc"


def test_bwd_variant_rule_views_take_the_tensor_cores():
    """``unbind`` views of a fused [B, L, 3, H, D] tensor, and ERNIE's q,
    k, v split from one fused projection [B, L, 3 * 1024], are read
    through their strides on the tensor cores."""
    q, k, v = _bf16(2, 128, 3, 4, 64).unbind(2)
    do = _bf16(2, 128, 4, 64)
    assert not q.is_contiguous() and fa._bwd_variant(q, k, v, do) == "tc"
    q, k, v = (t.reshape(8, 1024, 16, 64)
               for t in _bf16(8, 1024, 3 * 1024).split(1024, dim=-1))
    assert not q.is_contiguous()
    assert fa._bwd_variant(q, k, v, _bf16(8, 1024, 16, 64)) == "tc"
    # autograd's expanded dO is made contiguous before the rule sees it
    ones = torch.ones(2, 128, 4, 64, dtype=torch.bfloat16)
    assert fa._bwd_variant(q[:2, :128, :4], k[:2, :128, :4],
                           v[:2, :128, :4], ones) == "tc"


def test_bwd_variant_rule_fp32_unreadable_bf16_and_d256_take_the_cuda_cores():
    x = torch.empty(1, 256, 4, 128)
    assert fa._bwd_variant(x, x, x, x) == "cuda_core"       # fp32: no TF32
    ok = _bf16(1, 256, 4, 128)
    off = _bf16(1, 256, 4, 136)[..., 1:129]          # base 2 bytes off 16
    assert fa._bwd_variant(off, ok, ok, ok) == "cuda_core"
    assert fa._bwd_variant(ok, ok, ok, off) == "cuda_core"  # dO misaligned
    odd = _bf16(1, 256, 4, 130)[..., :128]           # head stride 130
    assert fa._bwd_variant(ok, odd, ok, ok) == "cuda_core"
    assert fa._bwd_variant(ok, ok, ok, odd) == "cuda_core"
    heads_first = _bf16(1, 4, 256, 128).transpose(1, 2)   # not nested
    assert fa._bwd_variant(heads_first, ok, ok, ok) == "cuda_core"
    # mixed dtypes: dO in fp32 beside bf16 q, k, v
    assert fa._bwd_variant(ok, ok, ok, ok.float()) == "cuda_core"
    # D = 256 stays on the CUDA cores: dK and dV alone would take 256 fp32
    # registers a thread; the forward's tensor-core kernel does take it
    big = _bf16(1, 128, 4, 256)
    assert 256 not in fa.BWD_TC_HEAD_DIMS
    assert fa._bwd_variant(big, big, big, big) == "cuda_core"
    assert fa._variant(big, big, big) == "tc"
