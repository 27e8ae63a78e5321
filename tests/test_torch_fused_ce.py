"""Fused LM-head cross-entropy of the PyTorch port against the JAX
package.

On CPU tensors ``ops.fused_ce.fused_ce_stats`` runs its plain version;
its ``(m, s, lab)`` must agree with the JAX package's Pallas
``fused_ce_stats`` (interpret mode) with a ``vocab_offset``, N and V that
are not multiples of the blocks, and labels on the last column and
outside this shard's columns. ``fused_ce_loss``'s value and ``(dh, dw)``
match JAX ``fused_ce_loss`` and ``jax.grad`` of the dense
``fused_ce_reference``; ``fused_linear_cross_entropy`` and
``cross_entropy`` match the JAX functionals. The CUDA kernel is held
against the plain version by the ``gpu``-marked tests and
``chip_smoke.py``.

Tolerance: fp32 throughout, the same sums in another order: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional.fused_ce import _fused_raw
from paddle_tpu.nn.functional.loss import cross_entropy as jax_ce
from paddle_tpu.ops.pallas import fused_ce as jfc
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_ce as tfc

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rng, N, H, V, vocab_offset=0):
    h = rng.standard_normal((N, H)).astype(np.float32)
    w = (0.3 * rng.standard_normal((H, V))).astype(np.float32)
    lab = rng.integers(vocab_offset, vocab_offset + V, N)
    lab[0] = vocab_offset + V - 1                 # the last column
    return h, w, lab


@pytest.mark.parametrize("N,H,V,offset", [
    (16, 32, 64, 0),        # N and V multiples of the blocks
    (13, 24, 45, 0),        # ragged N and V
    (13, 24, 45, 100),      # a shard of a larger vocabulary
])
def test_plain_stats_match_jax_kernel(N, H, V, offset):
    rng = np.random.default_rng(N + V + offset)
    h, w, lab = _case(rng, N, H, V, offset)
    lab[1] = offset + V + 3 if offset else lab[1]   # another shard's label
    want = jax.jit(lambda a, b, c: jfc.fused_ce_stats(
        a, b, c, vocab_offset=offset, block_n=8, block_v=16,
        interpret=True))(jnp.asarray(h), jnp.asarray(w),
                         jnp.asarray(lab, jnp.int32))
    got = tfc.fused_ce_stats(torch.from_numpy(h), torch.from_numpy(w),
                             torch.from_numpy(lab), vocab_offset=offset)
    for name, g, x in zip(("m", "s", "lab"), got, want):
        assert g.dtype == torch.float32 and g.shape == (N,)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL,
                                   err_msg=name)
    if offset:
        assert got[2][1] == 0


def test_fused_ce_loss_value_and_grads_match_jax():
    h, w, lab = _case(np.random.default_rng(5), 13, 24, 45)
    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab, jnp.int32)
    want_loss, (want_dh, want_dw) = jax.jit(jax.value_and_grad(
        lambda a, b: jfc.fused_ce_loss(a, b, jl, 8, 16, True),
        argnums=(0, 1)))(jh, jw)
    dense_dh, dense_dw = jax.grad(
        lambda a, b: jfc.fused_ce_reference(a, b, jl), argnums=(0, 1))(jh, jw)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = tfc.fused_ce_loss(th, tw, torch.from_numpy(lab), chunk_size=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(
        tfc.fused_ce_reference(th, tw, torch.from_numpy(lab)).item(),
        float(want_loss), **TOL)
    for g, x, d in ((th.grad, want_dh, dense_dh), (tw.grad, want_dw,
                                                   dense_dw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(d), **TOL)


def test_fused_linear_cross_entropy_matches_jax():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((24, 45))).astype(np.float32)
    lab = rng.integers(0, 45, (2, 7))
    jl = jnp.asarray(lab.reshape(-1), jnp.int32)
    want, (want_dh, want_dw) = jax.jit(jax.value_and_grad(
        lambda a, b: _fused_raw(a.reshape(-1, 24), b, jl, 16),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = F.fused_linear_cross_entropy(th, tw, torch.from_numpy(lab),
                                        chunk_size=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_with_ignore_index_matches_jax(reduction):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 11)).astype(np.float32)
    lab = rng.integers(0, 11, 9)
    lab[[2, 5]] = -100
    want = jax_ce(paddle.to_tensor(x), paddle.to_tensor(lab),
                  reduction=reduction)
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)
    # label smoothing is in the port since the nn layer library
    want = jax_ce(paddle.to_tensor(x), paddle.to_tensor(lab),
                  reduction=reduction, label_smoothing=0.1)
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          reduction=reduction, label_smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


def test_variant_rule_picks_the_tensor_cores_for_the_trainer_head():
    """``_variant`` reads dtype, strides and alignment only (CPU tensors
    here): the trainer head's bf16 hidden [4094, 4096] and w [4096, 32000]
    take the tensor cores, fp32 the CUDA cores."""
    h = torch.empty(4094, 4096, dtype=torch.bfloat16)
    w = torch.empty(4096, 32000, dtype=torch.bfloat16)
    assert tfc._variant(h, w) == "tc"
    assert tfc._variant(h.float(), w[:8].float()) == "cuda_core"
    # a 16-byte aligned vocabulary shard of a larger w
    assert tfc._variant(h, w[:, 8000:16000]) == "tc"


@pytest.mark.parametrize("V", [301, 50257])
def test_variant_rule_unaligned_vocab_takes_the_cuda_cores(V):
    """A row stride that is not a multiple of 16 bytes (the card test's
    V=301, GPT-2's 50257) cannot go through TMA; small H, as the rule
    reads only strides."""
    h = torch.empty(64, 32, dtype=torch.bfloat16)
    assert tfc._variant(h, torch.empty(32, V, dtype=torch.bfloat16)) == \
        "cuda_core"
    assert tfc._variant(h[:, 1:17], torch.empty(
        16, 512, dtype=torch.bfloat16)) == "cuda_core"   # base off 16 bytes
