"""The parity judges of ``chip_smoke.py`` phase 3 for the flash-attention
forward and backward and the fused-CE stats, held on CPU tensors at small
sizes to what they must do: pass the plain version (and a tiled
computation with the kernels' rounding, in another sum order), and fail
every planted fault made from the plain version.

- forward (``judge_forward``): ``||got - want|| / ||want||`` of out over
  all rows and over the last quarter of the rows, 1e-2 in bf16 and 1e-4 in
  fp32, lse max-abs 1e-3 / 1e-4. Faults: the causal mask shifted by one
  key; the last visible key tile of each 64-row block dropped.
- backward (``judge_backward``): ``||got - want|| / ||want||`` of each of
  dq, dk and dv over all rows (keys) and over the last quarter, 1e-2 in
  bf16 and 1e-4 in fp32. Faults: the causal mask shifted by one key; the
  last visible key tile of each 64-row block dropped from dq; the last
  visible query tile of each 64-key block dropped from dk/dv; one query
  head of each GQA group left out of dk/dv's sum.
- fused CE (``judge_ce``): (m, s, lab) within rtol 1e-4 / atol 1e-3.
  Faults: the last 128 vocabulary columns dropped; the label read one
  column off.
- ragged matmul (``judge_ragged``): ``||got - want|| / ||want||`` over
  the live rows, 1e-2 for a bf16 result and 1e-5 for an fp32 one, every
  row past the counts exactly 0, all finite. Faults (``ragged_faults``):
  counts ignored; half of K dropped; the last 64-deep K chunk dropped; the
  first K chunk summed twice; the rows of a partly live 128-row tile past
  the count given their product; the last 256-column tile computed
  against the next group's w.

- flash decode (``judge_decode``): ``||got - want|| / ||want||`` over the
  head dim of each (slot, head) that attends a position, 1e-2 in bf16 and
  1e-4 in fp32, exact zeros in a slot that attends none, all finite. It
  passes the plain version, a 64-position tiled online softmax and a
  split-K form whose chunks are merged by their lse. Faults
  (``decode_faults``): each slot's last attended position dropped; the
  last chunk of the longest slot dropped; a block-table entry of the
  longest slot read one block off at a chunk edge; with more than one kv
  head, each query head read against the next kv head (at group 1, head h
  against kv head h + 1) -- chunks of 64 positions and of the split
  kernel's split length.

The judges import torch and numpy only; the card applies them to the
kernels (``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_ce as fc
from paddle_tpu_torch.ops import ragged_matmul as rm


def _attn(rng, B, Lq, Lk, Hq, Hkv, D, dtype):
    mk = (lambda L, H: torch.from_numpy(
        rng.standard_normal((B, L, H, D)).astype(np.float32)).to(dtype))
    return mk(Lq, Hq), mk(Lk, Hkv), mk(Lk, Hkv)


def _tiled_online(q, k, v, causal, tile=64):
    """The forward as the kernels compute it: 64-key tiles, a running max
    and exp-sum, p rounded to v's dtype relative to the running max, O
    rescaled per tile (a legitimate result the judge must pass)."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    mask_value = -0.7 * float(torch.finfo(torch.float32).max)
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).repeat_interleave(group, 1).float()
    vh = v.transpose(1, 2).repeat_interleave(group, 1)
    mask = chip_smoke.causal_mask(Lq, Lk, causal, q.device)
    m = torch.full((B, Hq, Lq, 1), mask_value)
    l = torch.zeros(B, Hq, Lq, 1)
    o = torch.zeros(B, Hq, Lq, D)
    for k0 in range(0, Lk, tile):
        mk = mask[:, k0:k0 + tile]
        s = torch.matmul(qh, kh[:, :, k0:k0 + tile].transpose(-1, -2))
        s = (s / D ** 0.5).masked_fill(~mk, mask_value)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new).masked_fill(~mk, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(v.dtype).float(),
                                     vh[:, :, k0:k0 + tile].float())
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return (o / safe).to(q.dtype).transpose(1, 2), (m + torch.log(safe))[
        ..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,causal", [
    (1, 192, 192, 4, 4, 32, True),      # three 64-row blocks
    (1, 160, 224, 4, 2, 32, True),      # Lq < Lk, GQA
    (2, 200, 136, 2, 2, 16, True),      # Lq > Lk: fully masked rows
    (1, 128, 200, 2, 1, 32, False),     # non-causal, ragged keys
    (1, 256, 256, 3, 3, 64, True),      # GPT-2's causal D=64, MHA
])
def test_forward_judge_passes_the_plain_version_and_fails_the_faults(
        dtype, B, Lq, Lk, Hq, Hkv, D, causal):
    q, k, v = _attn(np.random.default_rng(Lq + Lk), B, Lq, Lk, Hq, Hkv, D,
                    dtype)
    want = fa.flash_attention(q, k, v, causal=causal)    # the plain version
    # the faults' source reproduces the plain version with the right mask
    same = chip_smoke.plain_attention(
        q, k, v, chip_smoke.causal_mask(Lq, Lk, causal, q.device))
    assert chip_smoke.judge_forward(*same, *want)[3]
    rel, tail, lse_err, ok = chip_smoke.judge_forward(
        *_tiled_online(q, k, v, causal), *want)
    assert ok, (rel, tail, lse_err)
    faults = chip_smoke.forward_faults(q, k, v, causal)
    assert len(faults) == 2
    for name, bad in faults.items():
        assert not chip_smoke.judge_forward(*bad, *want)[3], name


def test_forward_judge_sees_a_fault_in_the_late_rows_alone():
    """The last quarter of the rows is judged on its own: zeroing it
    fails the judge even where the norm over all rows would hide it
    behind the large early rows."""
    q, k, v = _attn(np.random.default_rng(0), 1, 512, 512, 2, 2, 32,
                    torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, causal=True)
    bad = out.clone()
    bad[:, -128:] = 0
    rel, tail, _, ok = chip_smoke.judge_forward(bad, lse, out, lse)
    assert not ok and tail > chip_smoke.FWD_REL_TOL[torch.bfloat16]


def _ce(rng, N, H, V, dtype, offset):
    h = torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
    w = torch.from_numpy(0.2 * rng.standard_normal((H, V)).astype(
        np.float32))
    lab = torch.from_numpy(rng.integers(offset, offset + V, N))
    lab[0] = offset + V - 1                 # the last column
    return h.to(dtype), w.to(dtype), lab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,V,offset", [(64, 64, 1000, 0),
                                          (33, 48, 333, 500)])
def test_ce_judge_passes_the_plain_version_and_fails_the_faults(
        dtype, N, H, V, offset):
    h, w, lab = _ce(np.random.default_rng(N + V), N, H, V, dtype, offset)
    want = fc.fused_ce_stats(h, w, lab, vocab_offset=offset)
    # the same stats walked in 128-column chunks (another sum order)
    tiled = fc.fused_ce_stats_reference(h, w, lab, offset, chunk=128)
    errs, ok = chip_smoke.judge_ce(tiled, want)
    assert ok, errs
    faults = chip_smoke.ce_faults(fc, h, w, lab, offset)
    assert len(faults) == 2
    for name, bad in faults.items():
        assert not chip_smoke.judge_ce(bad, want)[1], name


def _tiled_backward(q, k, v, do, lse, delta, causal, tile=64):
    """The backward as the tensor-core kernels compute it: p =
    2^(s scale log2e - lse log2e) with the row term kept finite, ds and p
    rounded to the operands' dtype, dq summed over 64-key tiles, dk/dv over
    64-row query tiles and then over the group's heads last to first
    (another sum order than the plain version's; a legitimate result the
    judge must pass)."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale, log2e = 1.0 / D ** 0.5, 1.4426950408889634
    qh, oh = (x.transpose(1, 2).float() for x in (q, do))
    kh, vh = (x.transpose(1, 2).repeat_interleave(group, 1).float()
              for x in (k, v))
    mask = chip_smoke.causal_mask(Lq, Lk, causal, q.device)
    row = lse.clamp_min(-1e30)[..., None] * log2e

    def p_ds(rows, keys):
        s = torch.matmul(qh[:, :, rows], kh[:, :, keys].transpose(-1, -2))
        x = torch.where(mask[rows, keys], s * scale * log2e - row[:, :, rows],
                        float("-inf"))
        p = torch.exp2(x)
        dp = torch.matmul(oh[:, :, rows], vh[:, :, keys].transpose(-1, -2))
        return p, p * (dp - delta[:, :, rows, None]) * scale

    everything = slice(None)
    dq = torch.zeros(B, Hq, Lq, D)
    for k0 in range(0, Lk, tile):
        keys = slice(k0, k0 + tile)
        _, ds = p_ds(everything, keys)
        dq += torch.matmul(ds.to(k.dtype).float(), kh[:, :, keys])
    dk = torch.zeros(B, Hq, Lk, D)
    dv = torch.zeros(B, Hq, Lk, D)
    for i0 in range(0, Lq, tile):
        rows = slice(i0, i0 + tile)
        p, ds = p_ds(rows, everything)
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           qh[:, :, rows])
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                           oh[:, :, rows])
    dk = dk.reshape(B, Hkv, group, Lk, D).flip(2).sum(2)
    dv = dv.reshape(B, Hkv, group, Lk, D).flip(2).sum(2)
    return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,causal", [
    (1, 192, 192, 4, 4, 32, True),      # three 64-row blocks
    (1, 160, 224, 4, 2, 32, True),      # Lq < Lk, GQA
    (2, 200, 136, 2, 2, 16, True),      # Lq > Lk: fully masked rows
    (1, 128, 200, 2, 1, 32, False),     # non-causal, ragged keys
])
def test_backward_judge_passes_the_plain_version_and_fails_the_faults(
        dtype, B, Lq, Lk, Hq, Hkv, D, causal):
    rng = np.random.default_rng(Lq + Lk + 1)
    q, k, v = _attn(rng, B, Lq, Lk, Hq, Hkv, D, dtype)
    do = _attn(rng, B, Lq, Lq, Hq, Hq, D, dtype)[0]
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    # the plain versions, through the wrappers on CPU tensors
    want = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
    # the faults' source reproduces the plain version with the right mask
    same = chip_smoke.plain_backward(
        q, k, v, do, lse, delta,
        chip_smoke.causal_mask(Lq, Lk, causal, q.device))
    for a, b in zip(same, want):
        assert torch.equal(a, b)
    rels, ok = chip_smoke.judge_backward(
        _tiled_backward(q, k, v, do, lse, delta, causal), want)
    assert ok, rels
    faults = chip_smoke.backward_faults(q, k, v, do, lse, delta, causal,
                                        want)
    assert len(faults) == 4
    for name, bad in faults.items():
        assert not chip_smoke.judge_backward(bad, want)[1], name


def test_backward_judge_sees_a_fault_in_the_late_keys_alone():
    """The last quarter of the keys is judged on its own: zeroing dk
    there fails the judge even where the norm over all keys would hide it
    behind the large early keys."""
    rng = np.random.default_rng(1)
    q, k, v = _attn(rng, 1, 512, 512, 2, 2, 32, torch.bfloat16)
    do = _attn(rng, 1, 512, 512, 2, 2, 32, torch.bfloat16)[0]
    out, lse = fa.flash_attention(q, k, v, causal=True)
    delta = fa.attention_delta(out, do)
    want = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
    bad = want[1].clone()
    bad[:, -128:] = 0
    rels, ok = chip_smoke.judge_backward((want[0], bad, want[2]), want)
    assert not ok and rels[1][1] > chip_smoke.BWD_REL_TOL[torch.bfloat16]


def _tiled_ragged(x, w, counts, out_dtype, depth=64):
    """The ragged product as the tensor-core kernel sums it, in another
    order: 64-deep K chunks accumulated in fp32, last chunk first, rows
    past the counts set to 0 by a select, rounded once to the output
    dtype (a legitimate result the judge must pass)."""
    G, C, K = x.shape
    acc = torch.zeros(G, C, w.shape[2])
    for k0 in reversed(range(0, K, depth)):
        acc += torch.bmm(x[..., k0:k0 + depth].float(),
                         w[:, k0:k0 + depth].float())
    live = torch.arange(C)[None, :] < counts.long()[:, None]
    return torch.where(live[..., None], acc, 0.0).to(out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,C,K,N,counts", [
    (5, 300, 200, 136, [1, 64, 127, 129, 300]),   # every tile edge
    (3, 260, 256, 264, [260, 0, 131]),            # an empty group
])
def test_ragged_judge_passes_the_plain_version_and_fails_the_faults(
        dtype, G, C, K, N, counts):
    rng = np.random.default_rng(C + K)
    x = torch.from_numpy(rng.standard_normal((G, C, K)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(0.05 * rng.standard_normal((G, K, N)).astype(
        np.float32)).to(dtype)
    cnt = torch.tensor(counts, dtype=torch.int32)
    tol = chip_smoke.RAGGED_TOL[dtype]
    want = rm.ragged_group_matmul(x, w, cnt)          # the plain version
    assert chip_smoke.judge_ragged(want, want, cnt, tol)[2]
    rel, zeros, ok = chip_smoke.judge_ragged(
        _tiled_ragged(x, w, cnt, dtype), want, cnt, tol)
    assert ok, (rel, zeros)
    faults = chip_smoke.ragged_faults(rm, x, w, cnt)
    assert len(faults) == 6
    for name, bad in faults.items():
        assert not chip_smoke.judge_ragged(bad, want, cnt, tol)[2], name


def test_ragged_faults_leave_out_what_the_input_cannot_show():
    """Counts on 128-row tile edges have no partly live tile, and one
    group has no next group's w: those two faults are left out, as at
    the MoE up shape of phase 3, where five faults are checked."""
    x = torch.ones(1, 256, 64)
    w = torch.ones(1, 64, 16)
    cnt = torch.tensor([128], dtype=torch.int32)
    assert len(chip_smoke.ragged_faults(rm, x, w, cnt)) == 4
    x2, w2 = x.expand(2, -1, -1), w.expand(2, -1, -1)
    cnt2 = torch.tensor([128, 256], dtype=torch.int32)
    assert len(chip_smoke.ragged_faults(rm, x2, w2, cnt2)) == 5


def _decode(rng, S, H, n_kv, hd, bs, mb, dtype):
    """Pools, block tables with distinct blocks per slot (0 past each
    slot's bound) and write positions from 0 up to a full table."""
    nb = mb + 1
    mk = (lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dtype))
    q, kc, vc = mk(S, H, hd), mk(nb, bs, n_kv, hd), mk(nb, bs, n_kv, hd)
    wp = rng.integers(0, mb * bs, S)
    wp[0], wp[-1] = 0, mb * bs - 1
    tables = np.zeros((S, mb), np.int32)
    for s in range(S):
        used = wp[s] // bs + 1
        tables[s, :used] = rng.choice(np.arange(1, nb), used, replace=False)
    return (q, kc, vc, torch.from_numpy(tables),
            torch.from_numpy(wp.astype(np.int32)))


def _decode_splits(q, kc, vc, tables, wp, size):
    """Flash decode in ``size``-position pieces of each slot's view:
    (m, l, acc) per piece in fp32, p rounded to v's dtype relative to the
    piece's running max as the kernel rounds it, pieces with no attended
    position left empty (l = 0)."""
    S, H, hd = q.shape
    n_kv = kc.shape[2]
    mask_value = -0.7 * float(torch.finfo(torch.float32).max)
    kv = kc[tables.long()].reshape(S, -1, n_kv, hd)
    vv = vc[tables.long()].reshape(S, -1, n_kv, hd)
    kh = kv.repeat_interleave(H // n_kv, 2).float()
    vh = vv.repeat_interleave(H // n_kv, 2)
    T = kv.shape[1]
    valid = torch.arange(T)[None, :] <= wp.long()[:, None]       # [S, T]
    out = []
    for c0 in range(0, T, size):
        sc = torch.einsum("shd,sthd->sht", q.float(), kh[:, c0:c0 + size])
        sc = sc / hd ** 0.5
        ok = valid[:, None, c0:c0 + size]
        sc = sc.masked_fill(~ok, mask_value)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m).masked_fill(~ok, 0.0)
        acc = torch.einsum("sht,sthd->shd", p.to(vh.dtype).float(),
                           vh[:, c0:c0 + size].float())
        out.append((m, p.sum(-1, keepdim=True), acc))
    return out


def _decode_tiled(q, kc, vc, tables, wp, tile=64):
    """The kernel's order: 64-position tiles folded into a running max,
    exp-sum and output; a slot that attends nothing writes zeros."""
    m = l = acc = None
    for mt, lt, at in _decode_splits(q, kc, vc, tables, wp, tile):
        if m is None:
            m, l, acc = mt, lt, at
            continue
        m_new = torch.maximum(m, mt)
        a, b = torch.exp(m - m_new), torch.exp(mt - m_new)
        m, l, acc = m_new, l * a + lt * b, acc * a + at * b
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe).to(q.dtype)


def _decode_split_k(q, kc, vc, tables, wp, split=256):
    """Split-K: each ``split``-position piece finished on its own (its
    normalized output and its lse), the pieces merged by their lse."""
    outs, lses = [], []
    for m, l, acc in _decode_splits(q, kc, vc, tables, wp, split):
        safe = torch.where(l > 0, l, torch.ones_like(l))
        outs.append(acc / safe)
        lses.append(torch.where(l > 0, m + torch.log(safe),
                                torch.full_like(m, -float("inf"))))
    lse = torch.stack(lses)                            # [n, S, H, 1]
    top = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isfinite(top), top, 0.0))
    tot = w.sum(0)
    out = (w * torch.stack(outs)).sum(0) / torch.where(tot > 0, tot, 1.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("edge", ["64", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,n_kv,hd,bs,mb", [
    (4, 8, 8, 64, 16, 128),      # 2048 positions at the engine's bs
    (4, 8, 2, 64, 16, 32),       # GQA
    (3, 4, 4, 64, 128, 4),       # a block spans two 64-position chunks
    (4, 12, 12, 64, 16, 32),     # GPT-2's heads (64, 1) at 512 positions
    (4, 12, 12, 64, 16, 64),     # and at its 1,024-position table
])
def test_decode_judge_passes_the_plain_version_and_fails_the_faults(
        dtype, S, H, n_kv, hd, bs, mb, edge):
    """The faults' chunk edges at 64 positions, and at the split kernel's
    split length (``split_plan``: 128 at 2048 positions, else 64)."""
    args = _decode(np.random.default_rng(S + H + mb), S, H, n_kv, hd, bs,
                   mb, dtype)
    wp = args[-1]
    tol = chip_smoke.DECODE_TOL[dtype]
    want = fd.flash_decode(*args)                     # the plain version
    assert chip_smoke.judge_decode(want, want, wp, tol)[2]
    for form in (_decode_tiled, _decode_split_k):
        rel, zeros, ok = chip_smoke.judge_decode(form(*args), want, wp, tol)
        assert ok, (form.__name__, rel, zeros)
    chunk = 64 if edge == "64" else fd.split_plan(mb, bs)[0]
    faults = chip_smoke.decode_faults(fd, *args, chunk=chunk)
    assert len(faults) == (4 if n_kv > 1 else 3)
    for name, bad in faults.items():
        assert not chip_smoke.judge_decode(bad, want, wp, tol)[2], name


def test_decode_judge_sees_one_dropped_position_of_a_long_slot():
    """One position dropped from each slot of 4096 positions fails the
    judge, where an absolute 2e-2 limit on the whole output (the check it
    replaces) passes it."""
    args = _decode(np.random.default_rng(1), 2, 8, 8, 64, 16, 256,
                   torch.bfloat16)
    wp = args[-1]
    wp[0] = wp[1] = 4095
    want = fd.flash_decode(*args)
    bad = fd.flash_decode(*args[:-1], wp - 1)
    assert torch.allclose(bad.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not chip_smoke.judge_decode(bad, want, wp, 1e-2)[2]


def test_decode_judge_wants_zeros_in_a_slot_with_no_position():
    """A slot whose write position is -1 attends nothing: the kernel's
    forms write zeros there and pass; the gathered plain version spreads
    its softmax evenly over the masked positions and does not."""
    args = _decode(np.random.default_rng(2), 3, 4, 4, 64, 16, 8,
                   torch.float32)
    wp = args[-1]
    wp[1] = -1
    want = fd.flash_decode(*args)
    tiled = _decode_tiled(*args)
    assert bool((tiled[1] == 0).all())
    assert chip_smoke.judge_decode(tiled, want, wp, 1e-4)[2]
    assert chip_smoke.judge_decode(_decode_split_k(*args), want, wp,
                                   1e-4)[2]
    rel, zeros, ok = chip_smoke.judge_decode(want, want, wp, 1e-4)
    assert rel == 0 and not zeros and not ok
