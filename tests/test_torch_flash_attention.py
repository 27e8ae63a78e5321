"""Flash-attention forward of the PyTorch port against the JAX package.

The port's ``flash_attention`` on a CPU tensor runs its plain version
``flash_attention_reference``; its ``(out, lse)`` must agree with the JAX
package's Pallas ``_fwd`` (interpret mode): causal and full, GQA,
``Lq != Lk`` (including fully masked rows), and lengths that are not a
multiple of the block. The CUDA kernel is held against the plain version
by the ``gpu``-marked test (and by ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import _fwd as jax_fwd
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

# fp32: the same arithmetic in another reduction order
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(rng, B, Lq, Lk, Hq, Hkv, D):
    q = rng.standard_normal((B, Lq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, Hkv, D)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, causal, block):
    sw = (lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2))
    out, lse = jax_fwd(sw(q), sw(k), sw(v), causal, 1.0 / np.sqrt(q.shape[-1]),
                       block, block, True)
    return np.asarray(jnp.swapaxes(out, 1, 2)), np.asarray(lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,block", [
    (1, 32, 32, 4, 4, 16, 16),     # MHA, L a multiple of the block
    (2, 40, 40, 4, 2, 16, 16),     # GQA, L not a multiple of the block
    (1, 24, 56, 4, 1, 8, 16),      # Lq < Lk (bottom-right causal)
    (1, 40, 24, 2, 2, 8, 8),       # Lq > Lk: the first causal rows see nothing
])
def test_plain_matches_jax_fwd(causal, B, Lq, Lk, Hq, Hkv, D, block):
    q, k, v = _inputs(np.random.default_rng(0), B, Lq, Lk, Hq, Hkv, D)
    want_out, want_lse = _jax(q, k, v, causal, block)
    out, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    assert out.shape == (B, Lq, Hq, D) and lse.shape == (B, Hq, Lq)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_sdpa_on_cpu_takes_the_plain_path_and_matches_jax_composite():
    """sdpa_raw records why a CPU tensor is ineligible; its composite is
    the JAX package's _xla_sdpa (GQA via repeat_interleave)."""
    from paddle_tpu.nn.functional.attention import _xla_sdpa
    q, k, v = _inputs(np.random.default_rng(1), 2, 128, 128, 8, 2, 16)
    got = F.sdpa_raw(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=True)
    assert F.attention_path()["path"] == "plain"
    assert "device=cpu" in F.attention_path()["reason"]
    want = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bf16(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16)


def test_variant_rule_main_path_bf16_takes_the_tensor_cores():
    """``_variant`` reads dtype, strides and alignment only, so it runs on
    CPU tensors: the main path's bf16 operands take the tensor cores."""
    llama = _bf16(2, 2048, 32, 128)                 # Llama-2-7B trainer
    assert fa._variant(llama, llama, llama) == "tc"
    assert fa._variant(*(_bf16(1, 512, 32, 128),) * 3) == "tc"   # forward
    # ERNIE-MoE: q, k, v split from one fused projection [B, L, 3 * 1024]
    q, k, v = (t.reshape(8, 1024, 16, 64)
               for t in _bf16(8, 1024, 3 * 1024).split(1024, dim=-1))
    assert not q.is_contiguous() and fa._variant(q, k, v) == "tc"
    gqa = _bf16(1, 512, 8, 128)                      # GQA group 4
    assert fa._variant(llama[:1, :512], gqa, gqa) == "tc"


def test_variant_rule_unbind_views_take_the_tensor_cores():
    q, k, v = _bf16(2, 128, 3, 4, 64).unbind(2)
    assert fa._variant(q, k, v) == "tc"


def test_variant_rule_fp32_and_unreadable_bf16_take_the_cuda_cores():
    x = torch.empty(1, 256, 4, 128)
    assert fa._variant(x, x, x) == "cuda_core"       # fp32: no TF32
    off = _bf16(1, 256, 4, 136)[..., 1:129]          # base 2 bytes off 16
    assert fa._variant(off, off, off) == "cuda_core"
    ok = _bf16(1, 256, 4, 128)
    odd = _bf16(1, 256, 4, 130)[..., :128]           # head stride 130
    assert fa._variant(ok, odd, ok) == "cuda_core"
    heads_first = _bf16(1, 4, 256, 128).transpose(1, 2)   # not nested
    assert fa._variant(heads_first, ok, ok) == "cuda_core"
