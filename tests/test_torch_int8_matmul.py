"""The port's int8 matmul against the JAX package's.

``ops.int8_matmul``'s plain version (what a CPU tensor runs, and what the
card's kernel is held to bit for bit) against the Pallas kernel
``int8_matmul_rescale`` in interpret mode, with M and N padding tails
(the Pallas wrapper pads to its blocks); ``_quant_rows`` and
``int8_linear``'s forward against the JAX functions. Inputs come from
numpy seeds.

Tolerances: every forward is exact (the int32 sums are exact and both
sides form ``acc.f32 * xs * ws`` in that order, then one cast). The
straight-through ``dx = ct @ (wq * ws)^T`` is an fp32 matmul summed in
another order: within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import int8_matmul as jim
from paddle_tpu_torch.ops import int8_matmul as tim

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = (rng.random((M, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, N)) * 0.02 + 1e-3).astype(np.float32)
    return xq, xs, wq, ws


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn", [
    (37, 200, 300, 16, 128),      # M and N tails, K not a multiple of 16
    (64, 256, 128, 64, 128),      # no tails
    (5, 96, 513, 8, 256),         # a one-column N tail
    (130, 128, 40, 256, 256)])    # blocks larger than the operands
def test_plain_version_equals_the_pallas_kernel(M, K, N, bm, bn, out_dtype):
    jdt, tdt = DTYPES[out_dtype]
    xq, xs, wq, ws = _operands(M, K, N, seed=M + K + N)
    want = jim.int8_matmul_rescale(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws),
        out_dtype=jdt, block_m=bm, block_n=bn, interpret=True)
    before = tim.int8_matmul_rescale.launches
    got = tim.int8_matmul_rescale(
        *(torch.from_numpy(a) for a in (xq, xs, wq, ws)), out_dtype=tdt,
        block_m=bm, block_n=bn)
    assert tim.int8_matmul_rescale.launches == before   # CPU: no kernel
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_quant_rows_equals_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 96)) * 3).astype(np.float32)
    x[2] = 0.0                                 # an all-zero row: scale 1e-10
    x[3, 5] = -x[3].__abs__().max() * 2        # a negative row maximum
    jq, js = jim._quant_rows(jnp.asarray(x))
    q, s = tim._quant_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[2].item() == np.float32(1e-10) and q[3, 5].item() == -127


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_int8_linear_forward_equals_jax(x_dtype):
    jdt, tdt = DTYPES[x_dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    _, _, wq, ws = _operands(1, 128, 72, seed=3)
    jx = jnp.asarray(x, jdt)
    want = jim.int8_linear(jx, jnp.asarray(wq), jnp.asarray(ws), jdt, True)
    got = tim.int8_linear(torch.from_numpy(_f32(jx)).to(tdt),
                          torch.from_numpy(wq), torch.from_numpy(ws), tdt)
    assert got.dtype == tdt and got.shape == (2, 3, 72)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_int8_linear_straight_through_dx_equals_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 128)).astype(np.float32)
    ct = rng.standard_normal((4, 5, 48)).astype(np.float32)
    _, _, wq, ws = _operands(1, 128, 48, seed=5)
    want = jax.grad(lambda a: jnp.sum(jim.int8_linear(
        a, jnp.asarray(wq), jnp.asarray(ws), jnp.float32, True)
        * jnp.asarray(ct)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    twq, tws = torch.from_numpy(wq), torch.from_numpy(ws)
    y = tim.int8_linear(tx, twq, tws, torch.float32)
    y.backward(torch.from_numpy(ct))
    assert tx.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(want)).max())
    # the int8 weight and its scale are inference buffers: no gradient
    tws.requires_grad_()
    tim.int8_linear(tx, twq, tws, torch.float32).sum().backward()
    assert tws.grad is None
