"""The split-K flash-decode kernel's arithmetic, plain, on the CPU.

``ops/flash_decode.py`` plans the kernel's splits from the table width
alone (``split_plan``); ``merge_partials`` below states, plain, the rule
by which the kernel's last block of a (slot, kv head) merges them. A
split-then-merge version built from those two -- each split's fp32
partial (m, l, acc) with p rounded to v's dtype, merged by their max and
sum -- must agree with the JAX package's Pallas kernel (interpret mode)
and its ``flash_decode_reference`` at the write positions where a split
kernel can go wrong: -1 (nothing attended), 0, a split edge minus one, the
edge itself, and a full table. Tolerances: fp32 1e-5 (the same arithmetic
in another order); bf16 ``judge_decode``'s 1e-2. The kernel itself runs on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.ops.pallas.flash_decode import flash_decode as jax_fd
from paddle_tpu.ops.pallas.flash_decode import \
    flash_decode_reference as jax_fd_ref
from paddle_tpu_torch.ops import flash_decode as fd

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@pytest.mark.parametrize("mb,bs,P,n_split", [
    (32, 16, 64, 8),        # the engine's table: a multiple of P
    (9, 8, 64, 2),          # 72 positions: not a multiple
    (4, 128, 64, 8),        # bs = 128: a split edge inside a block
    (3, 128, 64, 6),
    (5, 128, 64, 10),       # 640 positions, P % bs != 0
    (72, 16, 128, 9),       # past 1,024 positions P grows
    (73, 16, 128, 10),      # ... and the last split is short
    (256, 16, 256, 16),     # 4096 positions
    (33, 128, 320, 14),     # 4224: P a multiple of 64, not of bs
    (0, 16, 64, 1),         # an empty table still launches one split
    (1, 1, 64, 1),
])
def test_split_plan(mb, bs, P, n_split):
    got = fd.split_plan(mb, bs)
    assert got == (P, n_split)
    T = mb * bs
    assert P % fd.CHUNK == 0 and 1 <= n_split <= fd.MAX_SPLITS
    if T:
        assert (n_split - 1) * P < T <= n_split * P


def merge_partials(m, l, acc):
    """The split kernel's merge, plain: per-split fp32 partials ``m``,
    ``l`` ``[n, ...]`` (each split's running max and exp-sum) and ``acc``
    ``[n, ..., hd]`` (its unnormalised ``sum p v``) -> ``sum acc_i
    e^(m_i - M) / sum l_i e^(m_i - M)`` with ``M = max m_i``. A split
    with no position has ``m`` at the finite mask value and ``l = 0``, so
    its weight is 0 beside a live split; where no split has a position
    the result is 0 (no ``inf - inf``, no ``0 / 0``)."""
    M = m.amax(0)
    w = torch.exp(m - M)
    L = (w * l).sum(0)
    A = (w[..., None] * acc).sum(0)
    return A / torch.where(L > 0, L, torch.ones_like(L))[..., None]


def _split_merge(q, kc, vc, tables, wp):
    """The split kernel's arithmetic, plain: each ``P``-position split of a
    slot's view (``split_plan``) gives its fp32 partial -- the max ``m`` of
    its scores, ``l = sum e^(s - m)`` and ``acc = sum p v`` with ``p``
    rounded to v's dtype; a split with no attended position has ``m`` at
    the mask value and ``l = acc = 0`` -- and ``merge_partials`` combines
    them."""
    S, H, hd = q.shape
    _, bs, n_kv, _ = kc.shape
    mb = tables.shape[1]
    T = mb * bs
    P, n_split = fd.split_plan(mb, bs)
    kh = kc[tables.long()].reshape(S, T, n_kv, hd).repeat_interleave(
        H // n_kv, 2)
    vh = vc[tables.long()].reshape(S, T, n_kv, hd).repeat_interleave(
        H // n_kv, 2)
    sc = torch.einsum("shd,sthd->sht", q.float(), kh.float()) / hd ** 0.5
    valid = torch.arange(T)[None, :] <= wp.long()[:, None]        # [S, T]
    ms, ls, accs = [], [], []
    for j in range(n_split):
        part = slice(j * P, min((j + 1) * P, T))
        ok = valid[:, None, part]
        s = sc[..., part].masked_fill(~ok, MASK_VALUE)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None]).masked_fill(~ok, 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("sht,sthd->shd", p.to(vc.dtype).float(),
                                 vh[:, part].float()))
    out = merge_partials(torch.stack(ms), torch.stack(ls),
                            torch.stack(accs))
    return out.to(q.dtype)


def _case(seed, H, n_kv, hd, bs, mb):
    """Slots attending nothing, position 0, a split edge minus one, the
    edge, and the full table; distinct random blocks per slot."""
    rng = np.random.default_rng(seed)
    T = mb * bs
    P = fd.split_plan(mb, bs)[0]
    wp = np.array([-1, 0, P - 1, P, T - 1], np.int32)
    S, nb = len(wp), 2 * mb + 1
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    tables = np.stack([rng.permutation(nb)[:mb] for _ in range(S)])
    return q, kc, vc, tables.astype(np.int32), wp


def _jax(args, dtype):
    q, kc, vc, tables, wp = (jnp.asarray(a) for a in args)
    q, kc, vc = (a.astype(dtype) for a in (q, kc, vc))
    kern = jax_fd(q, kc, vc, tables, wp, kv_heads_per_step=1,
                  interpret=True)
    ref = jax_fd_ref(q, kc, vc, tables, wp)
    return (torch.from_numpy(np.array(kern.astype(jnp.float32))),
            torch.from_numpy(np.array(ref.astype(jnp.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,n_kv,hd,bs,mb", [
    (4, 2, 16, 16, 8),       # 128 positions, 2 splits of 64
    (4, 4, 16, 128, 2),      # 256 positions: split edges inside a block
    (4, 2, 16, 16, 72),      # 1152 positions: P = 128, 9 splits
])
def test_split_then_merge_matches_jax(dtype, H, n_kv, hd, bs, mb):
    args = _case(H + bs + mb, H, n_kv, hd, bs, mb)
    tdt = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(a).to(tdt) for a in args[:3])
    tables, wp = (torch.from_numpy(a) for a in args[3:])
    got = _split_merge(q, kc, vc, tables, wp)
    kern, ref = _jax(args, getattr(jnp, dtype))
    live = wp >= 0
    assert bool((got[~live] == 0).all())      # nothing attended: zeros
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), kern.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got[live].numpy(), ref[live].numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        tol = chip_smoke.DECODE_TOL[tdt]
        for want in (kern, ref):
            rel, zeros, ok = chip_smoke.judge_decode(got, want, wp, tol)
            assert ok, (rel, zeros)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,group", fd.SHAPES)
def test_every_built_operand_takes_the_split_kernel(hd, group, dtype):
    n_kv = 2
    q = torch.zeros(1, n_kv * group, hd, dtype=dtype)
    kc = torch.zeros(3, 16, n_kv, hd, dtype=dtype)
    fd.check_supported(dtype, n_kv * group, n_kv, hd)
    assert fd._variant(q, kc) == "split"
