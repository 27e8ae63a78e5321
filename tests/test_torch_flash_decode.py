"""Paged flash-decode of the PyTorch port against the JAX package.

The port's ``flash_decode`` on a CPU tensor runs its plain gathered
version; it must agree with the JAX package's Pallas kernel (interpret
mode) and its ``flash_decode_reference`` on the cases of
``tests/test_pallas_kernels.py``: GQA and MHA, ragged write positions,
trash-block table tails, ``write_pos = 0`` and a full table. The CUDA
kernel itself is held against the plain version by the ``gpu``-marked
test (and by ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_decode import flash_decode as jax_fd
from paddle_tpu.ops.pallas.flash_decode import \
    flash_decode_reference as jax_fd_ref
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.text.models import llama


def _case(rng, S, H, n_kv, hd, nb, bs, mb, wp=None):
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    tables = rng.integers(0, nb, (S, mb)).astype(np.int32)
    if wp is None:
        wp = rng.integers(0, mb * bs, (S,))
    return q, kc, vc, tables, np.asarray(wp, np.int32)


def _port(args, dtype=torch.float32, device="cpu"):
    q, kc, vc, tables, wp = args
    out = fd.flash_decode(
        torch.from_numpy(q).to(device, dtype),
        torch.from_numpy(kc).to(device, dtype),
        torch.from_numpy(vc).to(device, dtype),
        torch.from_numpy(tables).to(device),
        torch.from_numpy(wp).to(device))
    return out.float().cpu().numpy()


def _jax(args, dtype=jnp.float32):
    q, kc, vc, tables, wp = (jnp.asarray(a) for a in args)
    q, kc, vc = (a.astype(dtype) for a in (q, kc, vc))
    kern = jax_fd(q, kc, vc, tables, wp, kv_heads_per_step=1,
                  interpret=True)
    ref = jax_fd_ref(q, kc, vc, tables, wp)
    return (np.asarray(kern.astype(jnp.float32)),
            np.asarray(ref.astype(jnp.float32)))


# fp32: the same arithmetic in another reduction order
FP32_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,H,n_kv", [(3, 4, 2), (2, 8, 4), (2, 4, 4)])
def test_plain_matches_jax_kernel_and_reference(S, H, n_kv):
    """GQA (group 2) and MHA, ragged write positions, trash tails."""
    args = _case(np.random.default_rng(0), S, H, n_kv, hd=16, nb=7, bs=4,
                 mb=4)
    got = _port(args)
    kern, ref = _jax(args)
    np.testing.assert_allclose(got, ref, **FP32_TOL)
    np.testing.assert_allclose(got, kern, **FP32_TOL)


def test_write_pos_zero_and_full():
    """A slot attending only position 0, and one attending the whole
    table range."""
    args = _case(np.random.default_rng(1), 2, 2, 2, hd=8, nb=5, bs=4, mb=3,
                 wp=[0, 3 * 4 - 1])
    got = _port(args)
    kern, ref = _jax(args)
    np.testing.assert_allclose(got, ref, **FP32_TOL)
    np.testing.assert_allclose(got, kern, **FP32_TOL)


def test_bf16_plain_matches_jax_reference():
    """bf16 inputs, fp32 scores: both sides round p and the output to
    bf16, so they may differ by one bf16 ulp of the output (2^-8 relative)
    plus accumulation-order slack: atol = rtol = 2e-2."""
    args = _case(np.random.default_rng(2), 3, 8, 2, hd=32, nb=9, bs=8, mb=4)
    got = _port(args, dtype=torch.bfloat16)
    _, ref = _jax(args, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["LLAMA_TINY", "LLAMA2_7B", "LLAMA2_13B"])
def test_kernel_is_built_for_every_llama_config(name, dtype):
    """Every configuration the port ships can serve through the decode
    kernel (Engine(flash_decode=True) asks this at construction)."""
    c = getattr(llama, name)
    fd.check_supported(dtype, c.num_attention_heads, c.num_key_value_heads,
                       c.hidden_size // c.num_attention_heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,heads", [(768, 12), (1024, 16), (1280, 20),
                                          (1600, 25)])
def test_kernel_is_built_for_every_gpt2_size(hidden, heads, dtype):
    """GPT-2 small, medium, large and XL: 64-dim heads, no GQA."""
    fd.check_supported(dtype, heads, heads, hidden // heads)


@pytest.mark.parametrize("dtype,H,n_kv,hd,exc", [
    (torch.float16, 32, 32, 128, TypeError),
    (torch.float32, 32, 16, 64, ValueError),      # group 2 at hd 64 not built
    (torch.float32, 32, 32, 96, ValueError),      # head dim not built
    (torch.bfloat16, 64, 8, 128, ValueError),     # group 8 not built
    (torch.float32, 6, 4, 32, ValueError),        # heads not a multiple
])
def test_unbuilt_decode_shapes_are_rejected(dtype, H, n_kv, hd, exc):
    with pytest.raises(exc):
        fd.check_supported(dtype, H, n_kv, hd)
