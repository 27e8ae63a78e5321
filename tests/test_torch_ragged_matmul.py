"""Ragged grouped matmul of the PyTorch port against the JAX package.

On CPU tensors ``ops.ragged_matmul.ragged_group_matmul`` runs its plain
version (the masked einsum); it must agree with the JAX package's Pallas
``ragged_group_matmul`` (interpret mode) with C and N that are not
multiples of the blocks, an empty group, counts above C, and rows past
each count exactly 0. ``ragged_dot``'s value and gradients (dx through
the same function on ``w^T``, dw the masked per-group contraction) match
``jax.vjp`` of the JAX ``ragged_dot`` (custom VJP). The CUDA kernel is
held against the plain version by the ``gpu``-marked tests and
``chip_smoke.py``.

Tolerance: fp32 throughout, the same sums in another order: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import ragged_matmul as jrm
from paddle_tpu_torch.ops import ragged_matmul as rm

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rng, G, C, K, N):
    return (rng.standard_normal((G, C, K)).astype(np.float32),
            rng.standard_normal((G, K, N)).astype(np.float32))


def _jax_kernel(x, w, counts):
    return np.asarray(jax.jit(lambda a, b, c: jrm.ragged_group_matmul(
        a, b, c, block_m=8, block_n=8, interpret=True))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts, jnp.int32)))


@pytest.mark.parametrize("G,C,K,N,counts", [
    (4, 19, 8, 13, [0, 5, 19, 12]),     # unaligned C and N, an empty group
    (3, 16, 12, 24, [16, 8, 1]),        # C and N multiples of the blocks
    (3, 10, 5, 7, [25, 10, 0]),         # counts above C
])
def test_plain_version_matches_jax_kernel(G, C, K, N, counts):
    x, w = _case(np.random.default_rng(G + C), G, C, K, N)
    want = _jax_kernel(x, w, counts)
    before = rm.ragged_group_matmul.launches
    got = rm.ragged_group_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.tensor(counts, dtype=torch.int32))
    assert rm.ragged_group_matmul.launches == before      # CPU: no kernel
    assert got.shape == (G, C, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for g, n in enumerate(counts):
        assert not got[g, n:].any()              # exactly 0 past the count
        assert not want[g, n:].any()


def test_out_dtype_and_transposed_w():
    """``out_dtype`` sets the result's dtype; a strided ``w^T`` view (the
    backward's dx call) gives the product with the transposed copy."""
    x, w = _case(np.random.default_rng(7), 2, 9, 6, 5)
    counts = torch.tensor([4, 9], dtype=torch.int32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = rm.ragged_group_matmul(xt.bfloat16(), wt.bfloat16(), counts,
                                 out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = _jax_kernel(np.asarray(xt.bfloat16().float()),
                       np.asarray(wt.bfloat16().float()), [4, 9])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 9, 5)).astype(np.float32))
    wT = wt.transpose(1, 2)
    assert not wT.is_contiguous()
    np.testing.assert_allclose(
        rm.ragged_group_matmul(dy, wT, counts).numpy(),
        _jax_kernel(dy.numpy(), np.ascontiguousarray(wT.numpy()), [4, 9]),
        **TOL)


@pytest.mark.parametrize("counts", [[3, 8], [0, 11]])
def test_ragged_dot_value_and_grads_match_jax_vjp(counts):
    G, C, K, N = 2, 8, 4, 6
    rng = np.random.default_rng(sum(counts))
    x, w = _case(rng, G, C, K, N)
    dy = rng.standard_normal((G, C, N)).astype(np.float32)
    cj = jnp.asarray(counts, jnp.int32)
    y, vjp = jax.vjp(lambda a, b: jrm.ragged_dot(a, b, cj, True),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = rm.ragged_dot(xt, wt, torch.tensor(counts, dtype=torch.int32))
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw), **TOL)
    for g, n in enumerate(counts):         # rows past the count: no grad
        assert not xt.grad[g, n:].any()


def test_tile_arguments_are_accepted_and_do_not_change_the_result():
    x, w = _case(np.random.default_rng(3), 2, 12, 4, 9)
    args = (torch.from_numpy(x), torch.from_numpy(w),
            torch.tensor([12, 5], dtype=torch.int32))
    torch.testing.assert_close(
        rm.ragged_group_matmul(*args, block_m=8, block_n=16),
        rm.ragged_group_matmul(*args), rtol=0, atol=0)


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


def test_variant_rule():
    """``_variant`` picks the kernel before the launch from dtype, strides
    and alignment alone: the tensor cores ("tc") for the ERNIE-MoE
    expert operands (x [E, C, d] @ w_up [E, d, f], h @ w_down) and for
    dx's ``w.transpose(1, 2)``; the first, mma.sync kernel for bf16 that TMA
    cannot read; the CUDA cores for fp32."""
    E, C, d, f = 2, 64, 1024, 4096            # ERNIE-MoE's widths
    x, w_up, h, w_down = _bf16(E, C, d), _bf16(E, d, f), _bf16(E, C, f), \
        _bf16(E, f, d)
    assert rm._variant(x, w_up) == "tc"                       # MN-major
    assert rm._variant(h, w_down) == "tc"
    assert rm._variant(h, w_up.transpose(1, 2)) == "tc"       # K-major
    assert rm._variant(x, w_down.transpose(1, 2)) == "tc"
    # K a multiple of 8 but not of 64, N likewise: TMA fills the edges
    assert rm._variant(_bf16(2, 300, 200), _bf16(2, 200, 136)) == "tc"
    mma = [
        (_bf16(4, 19, 8), _bf16(4, 8, 13)),              # N % 8 != 0
        (_bf16(2, 64, 12), _bf16(2, 12, 64)),            # x rows 24 bytes
        (_bf16(2, 64, 68)[..., :64], _bf16(2, 64, 64)),  # K-sliced x
        (x, _bf16(E * d * f + 1)[1:].view(E, d, f)),     # w 2 bytes off
        (_bf16(2 * 64 * 64 + 1)[1:].view(2, 64, 64),
         _bf16(2, 64, 64)),                              # x 2 bytes off
        (x, _bf16(E, f, d, 2)[..., 0].transpose(1, 2)),  # no unit stride
        (_bf16(C, d).expand(E, C, d), w_up),             # x groups overlap
    ]
    for xa, wa in mma:
        assert rm._variant(xa, wa) == "mma_sync", (xa.stride(), wa.stride())
    f32 = torch.empty(E, C, 64), torch.empty(E, 64, 128)
    assert rm._variant(*f32) == "cuda_core"
    assert rm._variant(f32[0], f32[1].transpose(1, 2).contiguous()
                       .transpose(1, 2)) == "cuda_core"


@pytest.mark.parametrize("G,C,N,sms,runs", [
    (8, 2560, 4096, 132, 4),      # ERNIE up: 16 column tiles, 4 per run
    (8, 2560, 1024, 132, 4),      # ERNIE down and dx: 1 per run
    (1, 128, 8192, 132, 32),      # one row tile: one column tile per run
    (4, 19, 13, 132, 1),          # one column tile
    (8, 2560, 2304, 132, 3),      # 9 column tiles: 3 runs of 3
    (2, 1280, 3072, 132, 12),     # few row tiles: a column tile per run
    (64, 256, 1024, 132, 4),
])
def test_column_runs_fill_the_card_in_equal_runs(G, C, N, sms, runs):
    got = rm._col_runs(G, C, N, sms)
    n_ct = -(-N // rm._COLS)
    assert got == runs and 1 <= got <= n_ct
    # the kernel's runs [i n_ct / runs, (i + 1) n_ct / runs): none is twice
    # another
    lens = [(i + 1) * n_ct // got - i * n_ct // got for i in range(got)]
    assert sum(lens) == n_ct and max(lens) - min(lens) <= 1
