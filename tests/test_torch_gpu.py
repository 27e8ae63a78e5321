"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version, the engine's kernel path against its gathered path
(greedy, and sampled with chunked prefill; Llama and GPT), the threefry
words against the known ``jax.random`` words, and the tiny Llama and
ERNIE-MoE trainers and a PTQ'd tiny Llama on the card against the same
models on the CPU, the comm-efficient exchanges' int8 quantizer on the
card against the CPU, ``chip_smoke``'s multi-rank phases and phase 21
(mixed precision, attention dropout) at tiny size, BERT, T5, ViT and
``Conv2D`` at tiny size on the card against the CPU (the fp32 ``Conv2D``
also without the test's TF32 fixture), with phase 22 (the encoder
families) at tiny size, and the serving deployment path: a supervisor's
replay and a fleet's migration on the card against the CPU, and phase 23
at tiny size; the CNN path: the fp32 NHWC ``Conv2D`` and a bf16 batch
norm on the card against the CPU, with phase 25 (ResNet, ``Model``) at
tiny size; the nn layer library: an fp32 ``LSTM`` and an fp32
``Conv2DTranspose`` with cuDNN's TF32 left on globally (the port turns
it off for them) against the CPU, ``Embedding(padding_idx=)``'s zero
gradient on the padding row, and phase 28 at small size.

Every test is marked ``gpu`` and decides inside the ``cuda`` fixture
whether a card exists (skipping here, with a reason). This file imports
nothing of JAX or ``paddle_tpu``, so it also runs where JAX is not
installed; on the GPU machine:

    python -m pytest --noconftest -o 'markers=gpu: needs CUDA' -m gpu \
        tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_ce as fc
from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops import ragged_matmul as rm
from paddle_tpu_torch.ops import stochastic_round as sr
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.serving import Engine, SpecConfig
from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY,
                                          ErnieMoEForPretraining, GPTConfig,
                                          GPTForCausalLM)
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

pytestmark = pytest.mark.gpu

# fp32: reduction order only (TF32 off); bf16: a few bf16 ulps at |x| ~ 1
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_case(rng, S, H, n_kv, hd, nb, bs, mb):
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, n_kv, hd)).astype(np.float32)
    tables = rng.integers(0, nb, (S, mb)).astype(np.int32)
    wp = rng.integers(0, mb * bs, (S,)).astype(np.int32)
    wp[0], wp[-1] = 0, mb * bs - 1           # only position 0; a full table
    return q, kc, vc, tables, wp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,n_kv,hd,bs,mb,edges", [
    (3, 8, 4, 32, 8, 9, False),
    (4, 32, 32, 128, 16, 9, False),
    (2, 32, 8, 128, 16, 9, False),
    (2, 8, 8, 128, 128, 9, False),
    (4, 32, 32, 128, 16, 128, False),
    (4, 32, 32, 128, 16, 256, False),
    # slots at a split edge (P - 1, P, P + 1; P from split_plan)
    (5, 32, 32, 128, 16, 32, True),          # 512 positions, P = 64
    (5, 32, 8, 128, 128, 8, True),           # an edge inside a block
    (5, 8, 4, 32, 8, 200, True),             # 1600 positions, P = 128
    (5, 32, 8, 128, 16, 128, True),          # GQA 4 on the 2-stage ring
    (5, 32, 32, 128, 16, 256, True),         # 4096 positions, P = 256
    (5, 12, 12, 64, 16, 32, True),           # GPT-2's (64, 1), 512
    (5, 12, 12, 64, 16, 64, True)])          # and 1,024 positions
def test_flash_decode_kernel_matches_plain(cuda, dtype, S, H, n_kv, hd, bs,
                                           mb, edges):
    """Under ``chip_smoke.judge_decode`` (per (slot, head) relative
    error, zeros in a slot that attends nothing), up to 4096 positions,
    on the split kernel. The S slots of ``_decode_case`` (position 0
    alone, ragged ones or split edges, a full table) keep their inputs,
    and one more slot, put second, attends nothing."""
    q, kc, vc, tables, wp = _decode_case(np.random.default_rng(3), S, H,
                                         n_kv, hd, nb=40, bs=bs, mb=mb)
    if edges:
        P = fd.split_plan(mb, bs)[0]
        wp[1:4] = P - 1, P, P + 1
    q_empty = np.random.default_rng(4).standard_normal(
        (1, H, hd)).astype(np.float32)
    q = np.concatenate([q[:1], q_empty, q[1:]])
    tables = np.concatenate([tables[:1], tables[:1], tables[1:]])
    wp = np.concatenate([wp[:1], [-1], wp[1:]]).astype(np.int32)
    q, kc, vc, tables, wp = (torch.from_numpy(a).to(cuda)
                             for a in (q, kc, vc, tables, wp))
    q, kc, vc = (t.to(dtype) for t in (q, kc, vc))
    before = fd.flash_decode.launches
    split_before = fd.flash_decode.launches_by_variant["split"]
    got = fd.flash_decode(q, kc, vc, tables, wp)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    assert fd.flash_decode.launches_by_variant["split"] == split_before + 1
    want = fd.flash_decode_reference(q, kc, vc, tables, wp)
    rel, zeros, ok = chip_smoke.judge_decode(got, want, wp,
                                             chip_smoke.DECODE_TOL[dtype])
    assert ok, (rel, zeros)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_first_kernel_still_matches_plain(cuda, dtype):
    """The first version (``"one_pass"``), which phase 7 times beside the
    split kernel, forced at 2048 positions with GQA."""
    q, kc, vc, tables, wp = (torch.from_numpy(a).to(cuda) for a in
                             _decode_case(np.random.default_rng(5), 4, 32, 8,
                                          128, nb=40, bs=16, mb=128))
    q, kc, vc = (t.to(dtype) for t in (q, kc, vc))
    before = fd.flash_decode.launches_by_variant["one_pass"]
    with chip_smoke.forced_variant(fd, "one_pass"):
        got = fd.flash_decode(q, kc, vc, tables, wp)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches_by_variant["one_pass"] == before + 1
    want = fd.flash_decode_reference(q, kc, vc, tables, wp)
    rel, zeros, ok = chip_smoke.judge_decode(got, want, wp,
                                             chip_smoke.DECODE_TOL[dtype])
    assert ok, (rel, zeros)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mb", [32, 64])
def test_flash_decode_gpt2_heads_and_their_planted_faults(cuda, dtype, mb):
    """GPT-2's heads (head dim 64, group 1) at its engine's 512- and
    1,024-position tables, slots at a split edge, one slot empty, q a
    strided view as GPT's fused qkv projection gives it: the split kernel
    passes ``judge_decode`` and all four planted faults (``decode_faults``,
    the next-kv-head one reading head h against kv head h + 1) fail it,
    with chunk edges at 64 and at ``P``."""
    P = fd.split_plan(mb, 16)[0]
    q, kc, vc, tables, wp = chip_smoke.decode_case(
        8, 12, 12, 64, 16, mb, mb + 1, dtype, seed=mb,
        fixed=((2, P - 1), (3, P), (4, P + 1)))
    wp[1] = -1
    qkv = torch.zeros((8, 3 * 768), dtype=dtype, device=cuda)
    qkv[:, :768] = q.reshape(8, 768)
    q_view = qkv[:, :768].view(8, 12, 64)             # rows 3h apart
    before = fd.flash_decode.launches_by_variant["split"]
    got = fd.flash_decode(q_view, kc, vc, tables, wp)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches_by_variant["split"] == before + 1
    want = fd.flash_decode_reference(q, kc, vc, tables, wp)
    tol = chip_smoke.DECODE_TOL[dtype]
    rel, zeros, ok = chip_smoke.judge_decode(got, want, wp, tol)
    assert ok, (rel, zeros)
    for chunk in sorted({64, P}):
        faults = chip_smoke.decode_faults(fd, q, kc, vc, tables, wp, chunk)
        assert len(faults) == 4
        for name, bad in faults.items():
            assert not chip_smoke.judge_decode(bad, want, wp, tol)[2], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_first_kernel_at_gpt2_heads(cuda, dtype):
    """The first version forced at GPT-2's heads (64, 1), 1,024 positions,
    on a strided q: phase 7 times it beside the split kernel."""
    q, kc, vc, tables, wp = chip_smoke.decode_case(8, 12, 12, 64, 16, 64,
                                                   65, dtype, seed=7)
    qkv = torch.zeros((8, 3 * 768), dtype=dtype, device=cuda)
    qkv[:, :768] = q.reshape(8, 768)
    before = fd.flash_decode.launches_by_variant["one_pass"]
    with chip_smoke.forced_variant(fd, "one_pass"):
        got = fd.flash_decode(qkv[:, :768].view(8, 12, 64), kc, vc, tables,
                              wp)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches_by_variant["one_pass"] == before + 1
    want = fd.flash_decode_reference(q, kc, vc, tables, wp)
    rel, zeros, ok = chip_smoke.judge_decode(got, want, wp,
                                             chip_smoke.DECODE_TOL[dtype])
    assert ok, (rel, zeros)


def test_flash_decode_rejects_what_the_kernel_does_not_take(cuda):
    args = _decode_case(np.random.default_rng(4), 2, 8, 4, 32, 10, 8, 3)
    q, kc, vc, tables, wp = (torch.from_numpy(a).to(cuda) for a in args)
    with pytest.raises(TypeError, match="int32"):
        fd.flash_decode(q, kc, vc, tables.long(), wp)
    with pytest.raises(ValueError, match="head dim"):
        fd.flash_decode(q[..., :24].contiguous(), kc[..., :24].contiguous(),
                        vc[..., :24].contiguous(), tables, wp)
    with pytest.raises(ValueError, match="built for"):   # group 8
        fd.flash_decode(q, kc[:, :, :1].contiguous(),
                        vc[:, :, :1].contiguous(), tables, wp)
    odd = torch.zeros((2, 8 * 32 + 1), device=cuda)     # rows 1028 B apart
    with pytest.raises(ValueError, match="strides"):
        fd.flash_decode(odd[:, :256].view(2, 8, 32), kc, vc, tables, wp)
    with pytest.raises(ValueError, match="strides"):      # heads apart
        fd.flash_decode(q.transpose(0, 1).contiguous().transpose(0, 1), kc,
                        vc, tables, wp)


def test_engine_rejects_an_unbuilt_decode_shape_at_construction(cuda):
    """A model whose (head dim, group) the decode kernel is not built for
    fails when the kernel engine is made, not at its first decode step;
    the gathered engine serves it."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              num_key_value_heads=1)
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    with pytest.raises(ValueError, match="built for"):
        Engine(m, n_slots=2, max_len=64, flash_decode=True)
    eng = Engine(m, n_slots=2, max_len=64, flash_decode=False)
    h = eng.submit(np.arange(5), max_new_tokens=3)
    eng.drain()
    assert len(h.tokens) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,causal", [
    (1, 256, 256, 4, 4, 128, True),
    (2, 200, 200, 8, 2, 64, True),      # GQA, ragged length
    (1, 96, 160, 4, 4, 32, True),       # Lq < Lk
    (1, 160, 96, 2, 2, 64, True),       # Lq > Lk: fully masked rows
    (1, 128, 128, 2, 1, 256, False),
    (1, 256, 320, 4, 4, 128, True),     # Lk - Lq = 64: a warpgroup's rows
                                        # end a key tile before its block's
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Lq, Lk, Hq,
                                              Hkv, D, causal):
    g = torch.Generator(device=cuda).manual_seed(Lq + D)
    q = torch.randn(B, Lq, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Lk, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Lk, Hkv, D, generator=g, device=cuda).to(dtype)
    before = fa.flash_attention.launches
    (out, lse), variant = chip_smoke.launched_variant(
        fa.flash_attention, lambda: fa.flash_attention(q, k, v, causal))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert variant == ("tc" if dtype == torch.bfloat16 else "cuda_core")
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    # and the phase-3 judge: relative norms, all rows and the last quarter
    assert chip_smoke.judge_forward(out, lse, ref_out, ref_lse)[3]


def test_flash_attention_strided_inputs(cuda):
    """q/k/v as views of one fused [B, L, 3, H, D] tensor: read through
    their strides, no copy."""
    qkv = torch.randn(2, 128, 3, 4, 64, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    (out, lse), variant = chip_smoke.launched_variant(
        fa.flash_attention, lambda: fa.flash_attention(q, k, v, True))
    assert variant == "tc"
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    assert chip_smoke.judge_forward(out, lse, ref_out, ref_lse)[3]


ATTN_CASES = [
    (1, 256, 256, 4, 4, 128, True),
    (2, 200, 200, 8, 2, 64, True),      # GQA, ragged length
    (1, 96, 160, 4, 4, 32, True),       # Lq < Lk
    (1, 160, 96, 2, 2, 64, True),       # Lq > Lk: fully masked rows
    (1, 128, 128, 4, 1, 256, False),    # GQA group 4, D = 256
    (1, 72, 72, 2, 2, 256, True),       # D = 256, ragged
    (1, 256, 256, 8, 2, 128, True),     # GQA group 4, D = 128
    (1, 256, 320, 4, 4, 128, True),     # Lk - Lq = 64
    (1, 384, 320, 4, 2, 128, True),     # Lq - Lk = 64, GQA
    (1, 160, 96, 4, 4, 128, True),      # Lq > Lk at D = 128
    (2, 333, 333, 4, 4, 64, False),     # non-causal, ragged, D = 64
    (1, 200, 200, 4, 4, 128, False),    # non-causal, D = 128
]


def _bwd_variant_wanted(dtype, D):
    """The backward variant a case must take: bf16 on the tensor cores at
    the head dims they are built for (32, 64, 128), fp32 and D = 256 on
    the CUDA cores."""
    return ("tc" if dtype == torch.bfloat16 and D in (32, 64, 128)
            else "cuda_core")


def _attn_inputs(cuda, dtype, B, Lq, Lk, Hq, Hkv, D):
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + D)
    mk = (lambda L, H: torch.randn(B, L, H, D, generator=g,
                                   device=cuda).to(dtype))
    return mk(Lq, Hq), mk(Lk, Hkv), mk(Lk, Hkv), mk(Lq, Hq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,Hq,Hkv,D,causal", ATTN_CASES)
def test_flash_attention_bwd_kernels_match_plain(cuda, dtype, B, Lq, Lk, Hq,
                                                 Hkv, D, causal):
    q, k, v, do = _attn_inputs(cuda, dtype, B, Lq, Lk, Hq, Hkv, D)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    (dq, dk, dv), took = chip_smoke.run_backward(fa, q, k, v, do, lse,
                                                 delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want_variant = _bwd_variant_wanted(dtype, D)
    assert took == (want_variant, want_variant)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, delta, causal)
    # each gradient at its own scale (entries shrink along the sequence):
    # ||got - want|| / ||want|| below 1e-4 in fp32 (order only, TF32 off)
    # and 1e-2 in bf16 (the output's bf16 rounding alone is ~1e-3)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        want = want.float()
        assert (got.float() - want).norm() / want.norm() < tol
    if Lq > Lk and causal:
        assert (dq[:, :Lq - Lk] == 0).all()
    # and the phase-3 judge: relative norms, all rows and the last quarter
    assert chip_smoke.judge_backward((dq, dk, dv),
                                     (want_dq, want_dk, want_dv))[1]


def test_flash_attention_bwd_strided_inputs(cuda):
    """q/k/v as views of one fused [B, L, 3, H, D] tensor, dO a view of
    another: the tensor-core backward reads all four through their
    strides, no copy."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = torch.randn(2, 333, 3, 4, 128, generator=g, device=cuda).to(
        torch.bfloat16).unbind(2)
    do = torch.randn(2, 333, 3, 4, 128, generator=g, device=cuda).to(
        torch.bfloat16)[:, :, 1]
    out, lse = fa.flash_attention(q, k, v, causal=True)
    delta = fa.attention_delta(out, do)
    got, took = chip_smoke.run_backward(fa, q, k, v, do, lse, delta, True)
    assert took == ("tc", "tc")
    want = (fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                True),
            *fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  True))
    assert chip_smoke.judge_backward(got, want)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_backward_runs_the_kernels(cuda, dtype):
    """Autograd through the Function launches the forward kernel once and
    each backward kernel once, with an expanded (stride-0) dO, which the
    wrapper copies to a contiguous one: fp32 on the CUDA cores, bf16 on
    the tensor cores."""
    q, k, v, _ = _attn_inputs(cuda, dtype, 1, 128, 128, 2, 2, 64)
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    by_variant = [dict(f.launches_by_variant) for f in (
        fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    fa.flash_attention_fn(*t, causal=True).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in
                                                          counts)
    want_variant = _bwd_variant_wanted(dtype, 64)
    for f, before in zip((fa.flash_attention_bwd_dq,
                          fa.flash_attention_bwd_dkv), by_variant):
        assert f.launches_by_variant[want_variant] == \
            before[want_variant] + 1
    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    want = fa.flash_attention_backward_reference(
        q, k, v, out, lse, torch.ones_like(q), causal=True)
    if dtype == torch.float32:
        for x, w in zip(t, want):
            torch.testing.assert_close(x.grad, w, atol=1e-3, rtol=1e-3)
    else:
        assert chip_smoke.judge_backward([x.grad for x in t], want)[1]


def test_backward_kernels_refuse_an_unbuilt_head_dim(cuda):
    q, k, v, do = _attn_inputs(cuda, torch.float32, 1, 64, 64, 2, 2, 80)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, lse.clone(), True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse.clone(), True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fn(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,V,offset", [(64, 128, 512, 0),
                                          (77, 96, 1000, 0),
                                          (33, 64, 301, 500)])
def test_fused_ce_stats_kernel_matches_plain(cuda, dtype, N, H, V, offset):
    g = torch.Generator(device=cuda).manual_seed(N + V)
    h = torch.randn(N, H, generator=g, device=cuda).to(dtype)
    w = (0.2 * torch.randn(H, V, generator=g, device=cuda)).to(dtype)
    lab = torch.randint(offset, offset + V, (N,), generator=g, device=cuda)
    lab[0] = offset + V - 1                       # the last column
    lab[1] = offset + V + 7                       # another shard's label
    before = fc.fused_ce_stats.launches
    got, variant = chip_smoke.launched_variant(
        fc.fused_ce_stats,
        lambda: fc.fused_ce_stats(h, w, lab, vocab_offset=offset))
    torch.cuda.synchronize()
    assert fc.fused_ce_stats.launches == before + 1
    # V = 301: a row stride off 16 bytes takes the CUDA cores in bf16 too
    assert variant == ("tc" if dtype == torch.bfloat16 and V % 8 == 0
                       else "cuda_core")
    want = fc.fused_ce_stats_reference(h, w, lab, vocab_offset=offset)
    # logits sum H products: fp32 order only; bf16 inputs are exact in the
    # fp32 products, so the same tolerance holds
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
    assert got[2][1] == 0


@pytest.mark.parametrize("chunk,remat", [(256, False), (0, False),
                                         (256, "selective"), (0, True)])
def test_tiny_trainer_on_the_card_matches_the_cpu(cuda, chunk, remat):
    """LLAMA_TINY fp32 (TF32 off) through fleet + AdamW at seq 128 (the
    flash path), with the fused or the dense head and with or without
    remat: 3 steps on the card against the same weights on the CPU. Per
    step the card launches dq and dk/dv once per layer, the forward once
    per layer (twice under remat, which recomputes it in the backward)
    and the fused-CE kernel once with the fused head."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              fused_ce_chunk=chunk, remat=remat)
    pt.seed(0)
    gpu = LlamaForCausalLM(cfg, device=cuda)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state_dict(cpu, {k: v.cpu().numpy()
                                for k, v in gpu.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    n = cfg.num_hidden_layers
    per_step = ((2 if remat else 1) * n, n, n, 1 if chunk else 0)
    losses = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters()))
        step = opt.make_train_step(m, lambda mm, x, y: mm(x, labels=y))
        counts = (fa.flash_attention.launches,
                  fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches,
                  fc.fused_ce_stats.launches)
        losses[name] = [float(step(ids, ids)) for _ in range(3)]
        got = tuple(c - b for c, b in zip(
            (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches,
             fc.fused_ce_stats.launches), counts))
        want = tuple(3 * c for c in per_step) if name == "gpu" else \
            (0, 0, 0, 0)
        assert got == want, (name, got, want)
    # fp32 on both sides, sums in another order: the loss within 1e-4
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    assert losses["gpu"][2] < losses["gpu"][0]


def test_model_forward_takes_the_flash_path(cuda):
    cfg = dataclasses.replace(LLAMA_TINY, dtype="bfloat16")
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    cpu = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           device="cpu")
    load_numpy_state_dict(cpu, {k: v.float().cpu().numpy()
                                for k, v in m.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    before = fa.flash_attention.launches
    got = m(ids)
    assert F.attention_path()["path"] == "flash"
    assert fa.flash_attention.launches == before + cfg.num_hidden_layers
    want = cpu(ids)
    assert torch.isfinite(got).all()
    # bf16 model vs its fp32 twin on the CPU: bf16 rounding through two
    # layers; the argmax agrees on nearly every position
    agree = (got.float().argmax(-1).cpu() == want.argmax(-1)).float().mean()
    assert agree > 0.9


def test_model_forward_with_an_unbuilt_head_dim_takes_the_plain_path(cuda):
    """Head dim 80 is not one the attention kernel is built for: sdpa_raw
    records the plain path and why, launches nothing, and the logits match
    the model's fp32 twin on the CPU (TF32 off: reduction order only)."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", hidden_size=320,
                              num_attention_heads=4, num_key_value_heads=2)
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state_dict(cpu, {k: v.cpu().numpy()
                                for k, v in m.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    before = fa.flash_attention.launches
    got = m(ids)
    path = F.attention_path()
    assert path["path"] == "plain" and "head dims" in path["reason"]
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(got.cpu(), cpu(ids), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("block_size", [8, 128])
def test_engine_kernel_and_gathered_paths_token_identical(cuda, block_size):
    """The tiny fp32 model (full fp32 products) through the kernel engine
    and the gathered engine: identical tokens, one launch per layer per
    decode step on the kernel path and none on the other, at a small
    block and at one larger than the kernel's 64-position chunk."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, cfg.vocab_size, 18)
    prompts = [np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 6, 4, 9)]
    toks = {}
    for flash in (False, True):
        eng = Engine(m, n_slots=2, max_len=256, min_prompt_bucket=4,
                     block_size=block_size, flash_decode=flash)
        start = fd.flash_decode.launches
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.drain()
        toks[flash] = [list(h.tokens) for h in hs]
        launches = fd.flash_decode.launches - start
        steps = eng.stats()["decode_steps"]
        assert launches == (cfg.num_hidden_layers * steps if flash else 0)
        assert eng.cache.check_refcounts()
    assert toks[True] == toks[False]


def test_sampled_chunked_engine_kernel_and_gathered_token_identical(cuda):
    """Sampled (top-k, top-p, per-request temperature and seed) with
    chunked prefill, the tiny fp32 model: the kernel engine and the
    gathered engine give identical tokens, and the kernel runs once per
    layer per decode step while slots sit part-way through their chunks
    (inactive rows of the decode batch)."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    rng = np.random.default_rng(8)
    sys_p = rng.integers(0, cfg.vocab_size, 18)
    prompts = [np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 30, 4, 41)]
    toks = {}
    for flash in (False, True):
        eng = Engine(m, n_slots=2, max_len=256, min_prompt_bucket=4,
                     block_size=8, prefill_chunk=16, do_sample=True,
                     top_k=8, top_p=0.9, flash_decode=flash)
        start = fd.flash_decode.launches
        hs = [eng.submit(p, max_new_tokens=6, temperature=0.6 + 0.2 * i,
                         seed=1000 + i) for i, p in enumerate(prompts)]
        eng.drain()
        toks[flash] = [list(h.tokens) for h in hs]
        st = eng.stats()
        launches = fd.flash_decode.launches - start
        assert launches == (cfg.num_hidden_layers * st["decode_steps"]
                            if flash else 0)
        assert st["chunked_prefills"] == 4 and eng.cache.check_refcounts()
    assert toks[True] == toks[False]


def test_gpt_engine_kernel_and_gathered_paths_token_identical(cuda):
    """A GPT at head dim 64 (hidden 256, 4 heads, 2 layers, fp32, full fp32
    products) through the kernel engine and the gathered engine, greedy
    and sampled with chunked prefill: identical tokens, one launch per
    layer per decode step on the kernel path, equal to ``generate()``'s
    for greedy; the scoring forward takes the flash path."""
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=1024,
                    max_position_embeddings=256, dropout=0.0)
    pt.seed(0)
    m = GPTForCausalLM(cfg, device=cuda).eval()
    rng = np.random.default_rng(9)
    sys_p = rng.integers(0, cfg.vocab_size, 18)
    prompts = [np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 30, 4, 41)]
    for kw in ({}, dict(do_sample=True, top_k=8, top_p=0.9,
                        prefill_chunk=16)):
        toks = {}
        for flash in (False, True):
            eng = Engine(m, n_slots=2, max_len=256, min_prompt_bucket=4,
                         block_size=8, flash_decode=flash, **kw)
            start = fd.flash_decode.launches
            hs = [eng.submit(p, max_new_tokens=6, temperature=0.7,
                             seed=1000 + i) for i, p in enumerate(prompts)]
            eng.drain()
            toks[flash] = [list(h.tokens) for h in hs]
            launches = fd.flash_decode.launches - start
            assert launches == (cfg.num_hidden_layers
                                * eng.stats()["decode_steps"] if flash
                                else 0)
            assert eng.cache.check_refcounts()
        assert toks[True] == toks[False], kw
        if not kw:
            for p, t in zip(prompts, toks[True]):
                gen = m.generate(torch.from_numpy(p[None]).to(cuda),
                                 max_new_tokens=6)
                assert gen[0, len(p):].tolist() == t
    before = fa.flash_attention.launches
    with torch.inference_mode():
        m(torch.zeros((1, 128), dtype=torch.long, device=cuda))
    assert F.attention_path()["path"] == "flash"
    assert fa.flash_attention.launches == before + cfg.num_hidden_layers


@pytest.mark.parametrize("draft", ["ngram", "self"])
def test_speculative_engine_on_the_card_equals_the_plain_engine(cuda,
                                                                draft):
    """The tiny fp32 model with ``flash_decode=True``: the speculative
    engine (n-gram, and the model as its own draft) gives the plain
    engine's tokens; its plain decode steps (slots with no proposal, and
    the last token of each request) run the flash-decode kernel once per
    layer, all on the split kernel, and its verifies launch it never."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    pt.seed(0)
    m = LlamaForCausalLM(cfg, device=cuda)
    V = cfg.vocab_size
    rng = np.random.default_rng(10)
    masks = [np.isin(np.arange(V), [7]), None,
             np.isin(np.arange(V), [11, 13]), None]
    prompts = [np.full(9, 7), rng.integers(0, V, 6),
               np.asarray([11, 13] * 5), rng.integers(0, V, 11)]
    geo = dict(n_slots=2, max_len=64, min_prompt_bucket=4, block_size=8,
               flash_decode=True)

    def run(**kw):
        eng = Engine(m, **geo, **kw)
        start = fd.flash_decode.launches
        split = fd.flash_decode.launches_by_variant["split"]
        hs = []
        for i, (p, mask) in enumerate(zip(prompts, masks)):
            if i:
                eng.step()
            hs.append(eng.submit(p, max_new_tokens=12, logit_mask=mask))
        eng.drain()
        assert eng.cache.check_refcounts()
        return ([list(h.tokens) for h in hs], eng.stats(),
                fd.flash_decode.launches - start,
                fd.flash_decode.launches_by_variant["split"] - split)

    base = run()[0]
    spec = SpecConfig(draft="ngram" if draft == "ngram" else m, k=4)
    toks, st, launches, split = run(speculative=spec)
    assert toks == base
    assert st["spec_steps"] > 0 and st["spec_accepted_tokens"] > 0
    want = cfg.num_hidden_layers * (st["decode_steps"] - st["spec_steps"])
    assert launches == split == want > 0


def test_prng_words_on_the_card_equal_the_known_words(cuda):
    """The threefry words on the card (keys, splits, random bits) equal
    ``chip_smoke.PRNG_WORDS``, which ``tests/test_torch_prng.py`` holds to
    ``jax.random``, bit for bit; so do the uniform floats made from them
    and the CPU's."""
    assert chip_smoke.prng_words(prng, cuda) == chip_smoke.PRNG_WORDS
    keys = torch.stack([prng.prng_key(s) for s in (0, 11, 2**31,
                                                   2**32 - 1)])
    for lo, hi in ((0.0, 1.0), (torch.finfo(torch.float32).tiny, 1.0),
                   (-2.0, 3.0)):
        want = prng.uniform(keys, (4099,), lo, hi)
        got = prng.uniform(keys.to(cuda), (4099,), lo, hi).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ragged_rel_err(got, want, counts):
    """(||got - want|| / ||want|| over the live rows, rows past counts
    exactly 0)."""
    live = (torch.arange(got.shape[1], device=got.device)[None, :]
            < counts.long()[:, None])[..., None]
    g = torch.where(live, got.float(), 0.0)
    w = torch.where(live, want.float(), 0.0)
    return ((g - w).norm() / w.norm()).item(), bool(
        (torch.where(live, 0.0, got.float()) == 0).all())


# fp32: reduction order only (TF32 off); bf16: the output's rounding
RAGGED_TOLS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _variant_launches(before):
    """The launches per variant of the ragged kernel since ``before``."""
    return {k: n - before[k] for k, n in
            rm.ragged_group_matmul.launches_by_variant.items()
            if n != before[k]}


# (G, C, K, N, counts, operand form as in chip_smoke.RAGGED_CASES, the
# variant bf16 must take; fp32 takes "cuda_core")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,C,K,N,counts,form,bf16_variant", [
    (4, 19, 8, 13, [0, 5, 19, 12], "mn", "mma_sync"),   # unaligned, empty
    (3, 100, 64, 96, [150, 100, 7], "mn", "tc"),        # counts above C
    (2, 300, 72, 136, [300, 129], "mn", "tc"),          # several tiles
    (2, 300, 72, 136, [257, 0], "k", "tc"),             # dx's w^T as a view
    (2, 64, 40, 24, [33, 64], "k", "tc"),
    # the tensor-core kernel's tile edges: counts ending at 1, 64, 127, 129
    # and C of a 128-row tile; K and N multiples of 8 but not of 64, N past
    # one 256-column tile
    (5, 384, 256, 256, [1, 64, 127, 129, 384], "mn", "tc"),
    (5, 384, 256, 256, [1, 64, 127, 129, 384], "k", "tc"),
    (2, 256, 200, 192, [256, 100], "mn", "tc"),
    (2, 256, 192, 328, [130, 256], "mn", "tc"),
    (2, 256, 192, 392, [130, 256], "k", "tc"),
    # what TMA cannot read stays on the first kernel
    (2, 200, 64, 96, [200, 77], "x sliced", "mma_sync"),
    (2, 200, 64, 96, [130, 200], "w misaligned", "mma_sync"),
])
def test_ragged_kernel_matches_plain(cuda, dtype, G, C, K, N, counts, form,
                                     bf16_variant):
    x, _, w, cnt = chip_smoke.ragged_operands(G, C, K, N, counts, dtype,
                                              form, False, seed=C + K)
    want_variant = bf16_variant if dtype == torch.bfloat16 else "cuda_core"
    assert rm._variant(x, w) == want_variant
    before = rm.ragged_group_matmul.launches
    by_variant = dict(rm.ragged_group_matmul.launches_by_variant)
    got = rm.ragged_group_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert rm.ragged_group_matmul.launches == before + 1
    assert _variant_launches(by_variant) == {want_variant: 1}
    assert got.dtype == dtype and got.shape == (G, C, N)
    rel, zeros = _ragged_rel_err(got, rm.ragged_group_matmul_reference(
        x, w, cnt), cnt)
    assert zeros and rel < RAGGED_TOLS[dtype], rel


def test_ragged_kernel_out_dtype_and_dead_rows_never_read(cuda):
    """bf16 in, fp32 out; NaN in the rows past the counts never reaches
    the result."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 200, 64, generator=g, device=cuda).bfloat16()
    w = torch.randn(3, 64, 48, generator=g, device=cuda).bfloat16()
    cnt = torch.tensor([130, 0, 200], dtype=torch.int32, device=cuda)
    x[0, 130:] = float("nan")
    x[1] = float("nan")
    by_variant = dict(rm.ragged_group_matmul.launches_by_variant)
    got = rm.ragged_group_matmul(x, w, cnt, out_dtype=torch.float32)
    assert _variant_launches(by_variant) == {"tc": 1}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel, zeros = _ragged_rel_err(got, rm.ragged_group_matmul_reference(
        x, w, cnt, out_dtype=torch.float32), cnt)
    assert zeros and rel < 1e-5


def test_ragged_dot_backward_runs_the_kernel(cuda):
    """The forward and dx launch the kernel once each; dx and dw equal
    autograd through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(3, 70, 32, generator=g, device=cuda)
    w = torch.randn(3, 32, 48, generator=g, device=cuda)
    dy = torch.randn(3, 70, 48, generator=g, device=cuda)
    cnt = torch.tensor([70, 9, 0], dtype=torch.int32, device=cuda)
    t = [a.clone().requires_grad_() for a in (x, w)]
    r = [a.clone().requires_grad_() for a in (x, w)]
    before = rm.ragged_group_matmul.launches
    rm.ragged_dot(*t, cnt).backward(dy)
    torch.cuda.synchronize()
    assert rm.ragged_group_matmul.launches == before + 2
    rm.ragged_group_matmul_reference(*r, cnt).backward(dy)
    for a, b in zip(t, r):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def test_ragged_dot_bf16_runs_the_tensor_core_kernel(cuda):
    """bf16, as the ERNIE-MoE experts: the forward (w MN-major) and dx
    (w^T, K-major) both launch the tensor-core variant; dx and dw equal
    autograd through the plain version within bf16 rounding."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 200, 64, generator=g, device=cuda).bfloat16()
    w = (0.1 * torch.randn(3, 64, 136, generator=g, device=cuda)).bfloat16()
    dy = torch.randn(3, 200, 136, generator=g, device=cuda).bfloat16()
    cnt = torch.tensor([200, 77, 0], dtype=torch.int32, device=cuda)
    t = [a.clone().requires_grad_() for a in (x, w)]
    r = [a.clone().requires_grad_() for a in (x, w)]
    by_variant = dict(rm.ragged_group_matmul.launches_by_variant)
    rm.ragged_dot(*t, cnt).backward(dy)
    torch.cuda.synchronize()
    assert _variant_launches(by_variant) == {"tc": 2}
    rm.ragged_group_matmul_reference(*r, cnt).backward(dy)
    for a, b in zip(t, r):
        assert chip_smoke.rel_err(a.grad, b.grad) < 1e-2


def test_ragged_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 4, device=cuda)
    w = torch.randn(2, 4, 6, device=cuda)
    cnt = torch.tensor([8, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        rm.ragged_group_matmul(x, w.bfloat16(), cnt)
    with pytest.raises(ValueError, match="shapes"):
        rm.ragged_group_matmul(x, w[:, :3], cnt)
    with pytest.raises(ValueError, match="on CUDA"):
        rm.ragged_group_matmul(x, w, cnt.cpu())


def test_tiny_ernie_moe_on_the_card_matches_the_cpu(cuda):
    """ERNIE_MOE_TINY fp32 (TF32 off, dropout 0) with sparse dispatch and
    the ragged experts at seq 128 (the flash path): 3 steps on the card
    against the same weights on the CPU. Per step the card launches the
    ragged kernel 4 times (2 forward + 2 dx in the one MoE layer) and the
    flash forward, dq and dk/dv once per layer."""
    cfg = dataclasses.replace(ERNIE_MOE_TINY, dropout=0.0)
    pt.seed(0)
    gpu = ErnieMoEForPretraining(cfg, device=cuda)
    cpu = ErnieMoEForPretraining(cfg, device="cpu")
    load_numpy_state_dict(cpu, {k: v.cpu().numpy()
                                for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = rng.integers(0, cfg.vocab_size, (2, 128))
    n = cfg.num_hidden_layers
    counters = (rm.ragged_group_matmul, fa.flash_attention,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    losses = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        for blk in m.ernie.blocks:
            if blk.use_moe:
                blk.moe.dispatch_mode = "sparse"
                blk.moe.expert_kernel = "ragged"
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters()))
        step = opt.make_train_step(m, lambda mm, x, y: mm(x, labels=y))
        before = [c.launches for c in counters]
        losses[name] = [float(step(ids, labels)) for _ in range(3)]
        got = tuple(c.launches - b for c, b in zip(counters, before))
        want = (3 * 4, 3 * n, 3 * n, 3 * n) if name == "gpu" else (0,) * 4
        assert got == want, (name, got, want)
    # fp32 on both sides, sums in another order: the loss within 1e-4
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    assert losses["gpu"][2] < losses["gpu"][0]


def _same_bits(a, b):
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _int8_operands(cuda, M, K, N, seed):
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (M, K), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (K, N), generator=g).to(torch.int8)
    xs = torch.rand(M, 1, generator=g) * 0.02 + 1e-3
    ws = torch.rand(1, N, generator=g) * 0.02 + 1e-3
    return tuple(t.to(cuda) for t in (xq, xs, wq, ws))


@pytest.mark.parametrize("layout", ["K-major", "row-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (37, 200, 300),
                                   (130, 128, 40), (128, 4096, 256),
                                   (17, 48, 16), (300, 1000, 129)])
def test_int8_kernel_matches_plain_bit_for_bit(cuda, dtype, M, K, N,
                                               layout):
    """Both layouts of wq; the K-major one (``Int8Linear.qweight``'s) takes
    the tensor cores where TMA can read it (K % 16 == 0), everything else
    the first kernel."""
    xq, xs, wq, ws = _int8_operands(cuda, M, K, N, seed=M + K + N)
    w = wq.t().contiguous().t() if layout == "K-major" else wq
    must = "tc" if layout == "K-major" and K % 16 == 0 else "mma_sync"
    before = im.int8_matmul_rescale.launches
    got, variant = chip_smoke.launched_variant(
        im.int8_matmul_rescale,
        lambda: im.int8_matmul_rescale(xq, xs, w, ws, out_dtype=dtype))
    torch.cuda.synchronize()
    assert im.int8_matmul_rescale.launches == before + 1
    assert variant == must
    want = im.int8_matmul_rescale_reference(xq, xs, wq, ws, dtype)
    assert _same_bits(got, want)
    # and the plain version on the card is the CPU's (int32 sums)
    cpu = im.int8_matmul_rescale_reference(*(t.cpu() for t in (xq, xs, wq,
                                                               ws)), dtype)
    assert _same_bits(want.cpu(), cpu)


def test_int8_kernel_rejects_what_it_does_not_take(cuda):
    xq, xs, wq, ws = _int8_operands(cuda, 8, 64, 16, seed=1)
    with pytest.raises(ValueError, match="on CUDA"):
        im.int8_matmul_rescale(xq, xs.cpu(), wq, ws)
    with pytest.raises(TypeError, match="int8"):
        im.int8_matmul_rescale(xq.float(), xs, wq, ws)
    with pytest.raises(TypeError, match="float32"):
        im.int8_matmul_rescale(xq, xs.half(), wq, ws)
    with pytest.raises(TypeError, match="out_dtype"):
        im.int8_matmul_rescale(xq, xs, wq, ws, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="shapes"):
        im.int8_matmul_rescale(xq, xs, wq[:32], ws)
    with pytest.raises(ValueError, match="scales"):
        im.int8_matmul_rescale(xq, xs.reshape(-1), wq, ws)
    # a truly strided wq (neither [K, N] nor [N, K] contiguous) is refused
    wide = torch.cat([wq, wq], 1)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul_rescale(xq, xs, wide[:, :16], ws)
    # the K-major view (Int8Linear.qweight's layout) is taken, by the
    # tensor cores
    got, variant = chip_smoke.launched_variant(
        im.int8_matmul_rescale,
        lambda: im.int8_matmul_rescale(xq, xs, wq.t().contiguous().t(), ws))
    assert variant == "tc"
    assert _same_bits(got, im.int8_matmul_rescale_reference(xq, xs, wq, ws))


def test_int8_linear_moved_to_the_card_stays_k_major(cuda, monkeypatch):
    """``Module.to``/``.cuda()`` keep qweight's K-major strides, so the
    layer's forward takes the tensor cores with no copy of the weight."""
    monkeypatch.setenv("PADDLE_TPU_INT8_MXU", "1")
    torch.manual_seed(0)
    lin = Linear(256, 96, device="cpu")
    m = tq.Int8Linear.from_linear(lin).cuda()
    assert m.qweight.is_cuda and m.qweight.t().is_contiguous()
    m.act_scale.fill_(0.05)
    x = torch.randn(3, 256, device=cuda)
    y, variant = chip_smoke.launched_variant(im.int8_matmul_rescale,
                                             lambda: m(x))
    assert variant == "tc"
    cpu = tq.Int8Linear.from_linear(lin)
    cpu.act_scale.fill_(0.05)
    assert torch.equal(y.cpu(), cpu(x.cpu()).detach())


def test_int8_linear_backward_on_the_card(cuda):
    xq, xs, wq, ws = _int8_operands(cuda, 1, 128, 48, seed=2)
    x = torch.randn(4, 5, 128, generator=torch.Generator().manual_seed(0))
    ct = torch.randn(4, 5, 48, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        xx = x.to(dev).requires_grad_()
        before = im.int8_matmul_rescale.launches
        y = im.int8_linear(xx, wq.to(dev), ws.to(dev), torch.float32)
        y.backward(ct.to(dev))
        assert im.int8_matmul_rescale.launches == before + (
            1 if dev.type == "cuda" else 0)
        grads[dev.type] = (y.detach().cpu(), xx.grad.cpu())
    assert torch.equal(grads["cuda"][0], grads["cpu"][0])
    # fp32 sums in another order (TF32 off)
    torch.testing.assert_close(grads["cuda"][1], grads["cpu"][1],
                               atol=1e-5, rtol=1e-5)


def test_tiny_ptq_llama_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """LLAMA_TINY fp32, PTQ (abs_max) on the card and on the CPU from the
    same weights and calibration batches, every Int8Linear on the int8
    route (PADDLE_TPU_INT8_MXU=1): identical int8 buffers, act_scale within
    1e-5 (fp32 activations in another order), one kernel launch per
    Int8Linear per forward, and logits within 5e-2 relative norm: the
    card's fp32 activations differ from the CPU's by reduction order, and
    a value that close to a rounding boundary of the activation QDQ or of
    the per-row quantization rounds the other way (one int8 step of its
    row) and spreads through the later layers (2.1e-2 measured on an
    H100). Each layer alone is exact: see the int8_linear test above."""
    monkeypatch.setenv("PADDLE_TPU_INT8_MXU", "1")
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    pt.seed(0)
    gpu = LlamaForCausalLM(cfg, device=cuda)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state_dict(cpu, {k: v.cpu().numpy()
                                for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    calib = [rng.integers(0, cfg.vocab_size, (2, 128)) for _ in range(2)]
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        dev = next(m.parameters()).device
        tq.PostTrainingQuantization(m).quantize(
            [torch.as_tensor(c, device=dev) for c in calib])
        n = sum(isinstance(x, tq.Int8Linear) for x in m.modules())
        assert all(x.qweight.t().is_contiguous() for x in m.modules()
                   if isinstance(x, tq.Int8Linear))     # K-major
        before = im.int8_matmul_rescale.launches
        tc = im.int8_matmul_rescale.launches_by_variant["tc"]
        with torch.inference_mode():
            out[name] = m(ids).float().cpu()
        assert im.int8_matmul_rescale.launches - before == (
            n if name == "gpu" else 0)
        # every launch on the tensor cores
        assert im.int8_matmul_rescale.launches_by_variant["tc"] - tc == (
            n if name == "gpu" else 0)
    sg, sc = gpu.state_dict(), cpu.state_dict()
    for k, v in sc.items():
        if k.endswith((".qweight", ".scale")):
            assert torch.equal(sg[k].cpu(), v), k
        elif k.endswith(".act_scale"):
            torch.testing.assert_close(sg[k].cpu(), v, rtol=1e-5, atol=0)
    rel = (out["gpu"] - out["cpu"]).norm() / out["cpu"].norm()
    assert torch.isfinite(out["gpu"]).all() and rel < 5e-2, rel


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 5), (256, 256),
                                   (999, 1001)])
def test_stochastic_kernels_match_plain_bit_for_bit(cuda, shape, seed):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(
        shape[1])).to(cuda) * 3
    words = sr.random_bits(seed, x.numel(), device=cuda)
    b0 = (sr.stochastic_round_bf16.launches,
          sr.quantize_int8_stochastic.launches)
    a = sr.stochastic_round_bf16(x, seed)
    q, s = sr.quantize_int8_stochastic(x, seed)
    torch.cuda.synchronize()
    assert (sr.stochastic_round_bf16.launches,
            sr.quantize_int8_stochastic.launches) == (b0[0] + 1, b0[1] + 1)
    assert _same_bits(a, sr.stochastic_round_bf16_reference(x, words))
    q2, s2 = sr.quantize_int8_stochastic_reference(x, words)
    assert _same_bits(q, q2) and _same_bits(s, s2)
    # the words on the card are the CPU's
    assert torch.equal(words.cpu(), sr.random_bits(seed, x.numel()))


def test_stochastic_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(8, 6, device=cuda)
    for fn in (sr.stochastic_round_bf16, sr.quantize_int8_stochastic):
        with pytest.raises(TypeError, match="float32"):
            fn(x.bfloat16())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t())
    with pytest.raises(ValueError, match="empty"):
        sr.quantize_int8_stochastic(x[:0])
    # the public functions take any 2-D float input and reach the kernels
    before = sr.stochastic_round_bf16.launches
    assert tq.stochastic_round(x.t(), seed=1).shape == (6, 8)
    assert sr.stochastic_round_bf16.launches == before + 1


# -- phase 12: hybrid Fleet training at a small size --------------------------

def _bf16_tiny():
    # head dim 32, L = 256: the flash kernels' tensor-core variants; vocab
    # 1024: the fused CE's
    return dataclasses.replace(LLAMA_TINY, dtype="bfloat16")


def test_phase12a_world1_hybrid_step_equals_the_plain_step(cuda):
    """``chip_smoke`` 12a at LLAMA_TINY size: stage 3 over NCCL at world 1
    gives the plain step's losses bit for bit and its launches."""
    small = _bf16_tiny()
    _, train = chip_smoke.phase_train(fa, fc, rm, LlamaForCausalLM, small,
                                      fleet, optimizer, pt.seed, layers=2,
                                      batch=(2, 256))
    out = chip_smoke.phase_hybrid_world1(fa, fc, rm, LlamaForCausalLM, small,
                                         fleet, optimizer, pt.seed, train,
                                         layers=2, batch=(2, 256))
    assert out["backend"] == "nccl" and out["losses"] == train["losses"]


def test_phase12b_two_ranks_on_one_card_match_world1(cuda, tmp_path):
    """``chip_smoke`` 12b at LLAMA_TINY size: mp2 and sharding2 stage 3 on
    two gloo ranks sharing the card, against the world-1 run."""
    out = chip_smoke.phase_hybrid_pair(
        fa, fc, rm, LlamaForCausalLM, _bf16_tiny(), fleet, optimizer,
        pt.seed, layers=2, batch=(2, 256), workdir=str(tmp_path / "p12"))
    ran = [n for n, c in out["configs"].items() if "left_out" not in c]
    assert ran, out["probe"]
    for name in ran:
        assert out["configs"][name]["max_rel_to_world1"] <= \
            chip_smoke.PAIR_REL_TOL


# -- sequence parallel (ring contract; phase 15) ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 4, 128), (8, 2, 64)])
def test_bwd_kernels_with_a_lse_merged_from_two_key_chunks(cuda, dtype, Hq,
                                                         Hkv, D):
    """The ring's contract for rows 2-3: each key chunk's dq and dk/dv
    from the lse and delta merged over both chunks (the diagonal chunk
    causal, the earlier one whole) match their plain versions, and summed
    over the chunks they are the whole sequence's gradients."""
    from paddle_tpu_torch.ops import ring_attention as ra
    q, k, v, do = _attn_inputs(cuda, dtype, 1, 512, 1024, Hq, Hkv, D)
    chunks = ((k[:, :512], v[:, :512], False), (k[:, 512:], v[:, 512:], True))
    parts = [ra._chunk_attn(q, kc, vc, 1.0 / D ** 0.5, c)
             for kc, vc, c in chunks]
    out, lse = ra._merge(*parts[0], *parts[1])
    delta = fa.attention_delta(out, do)
    grads = []
    for kc, vc, c in chunks:
        dq = fa.flash_attention_bwd_dq(q, kc, vc, do, lse, delta, c)
        dk, dv = fa.flash_attention_bwd_dkv(q, kc, vc, do, lse, delta, c)
        want = (fa.flash_attention_bwd_dq_reference(q, kc, vc, do, lse,
                                                    delta, c),
                *fa.flash_attention_bwd_dkv_reference(q, kc, vc, do, lse,
                                                      delta, c))
        assert chip_smoke.judge_backward((dq, dk, dv), want)[1]
        grads.append((dq, dk, dv))
    # the whole sequence: queries at the last 512 of 1024 keys
    o1, lse1 = fa.flash_attention(q, k, v, causal=True)
    assert chip_smoke.judge_forward(out, lse, o1, lse1)[3]
    want = fa.flash_attention_backward_reference(q, k, v, o1, lse1, do,
                                                 causal=True)
    dq = (grads[0][0].float() + grads[1][0].float()).to(dtype)
    dk = torch.cat([grads[0][1], grads[1][1]], dim=1)
    dv = torch.cat([grads[0][2], grads[1][2]], dim=1)
    assert chip_smoke.judge_backward((dq, dk, dv), want)[1]


def test_phase15_sequence_parallel_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 15 at LLAMA_TINY size (bf16, head dim 32, 512
    positions, selective remat): the probe, 15a at [1, 512, 8, 64] with
    its planted faults, and 15b ring and Ulysses on two gloo ranks
    against world 1, launches per ``want_sep_launches``."""
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    cell = dict(dataclasses.asdict(_bf16_tiny()), remat="selective")
    out = chip_smoke.phase_sep(fa, fc, rm, LlamaConfig, LlamaForCausalLM,
                               fleet, optimizer, pt.seed, cell=cell,
                               batch=(1, 512), ops_shape=(1, 512, 8, 64),
                               workdir=str(tmp_path / "p15"))
    for mode in chip_smoke.SEP_MODES:
        assert out["cells"][mode]["max_rel_to_world1"] <= \
            chip_smoke.SEP_REL_TOL


# -- pipeline parallel (phase 16) ---------------------------------------------

def test_phase16_pipeline_parallel_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 16 at LLAMA_TINY size (bf16, head dim 32, 256
    positions, 4 layers, 4 micro-batches): 16a's bodies against world 1
    under ``judge_rel`` with their planted faults, and 16b's GPipe and
    1F1B steps on two gloo ranks against world 1, launches per
    ``want_pp_launches``, host-staged calls per ``pp_p2p_calls``."""
    from paddle_tpu_torch.text.models import LlamaForCausalLMPipe
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    cfg = dataclasses.replace(_bf16_tiny(), num_hidden_layers=4)
    out = chip_smoke.phase_pp(fa, fc, rm, LlamaConfig, LlamaForCausalLMPipe,
                              fleet, optimizer, pt.seed, cfg=cfg,
                              batch=(4, 256), workdir=str(tmp_path / "p16"))
    for schedule in chip_smoke.PP_SCHEDULES:
        assert out["cells"][schedule]["max_rel_to_world1"] <= \
            chip_smoke.PP_REL_TOL
    assert out["cells"]["1f1b"]["max_in_flight_per_rank"] == [2, 1]


# -- GPT training and expert parallel (phases 17 and 18) ----------------------

def test_phase17_gpt_training_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 17 at GPT_TINY size (bf16, head dim 32, 128
    positions, dropout 0.1): 17a on the card with rows 1-3 on the q/k/v
    views of the fused qkv, each launch on ``"tc"``
    (``want_attention_launches``), and 17b at tp2 on two gloo ranks
    against 17a."""
    from paddle_tpu_torch.text.models import GPT_TINY
    cfg = dataclasses.replace(GPT_TINY, dtype="bfloat16")
    launches, out = chip_smoke.phase_gpt2_train(
        fa, fc, rm, GPTConfig, GPTForCausalLM, fleet, optimizer, pt.seed,
        cfg=cfg, batch=(4, 128), workdir=str(tmp_path / "p17"))
    want = chip_smoke.want_attention_launches(cfg.num_hidden_layers)
    assert launches == want
    assert out["tp2"]["launches_per_rank_step"] == want
    assert out["tp2"]["max_rel_to_world1"] <= chip_smoke.PAIR_REL_TOL


def test_phase18_expert_parallel_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 18 at ERNIE_MOE_TINY size (bf16, 4 experts,
    head dim 32, 4 x 128 tokens): mp2 on two gloo ranks against world 1,
    the ragged kernel on each rank's 2 experts and rows 1-3, every launch
    on ``"tc"``; the probed gradients within 1e-2 and both planted faults
    outside."""
    from paddle_tpu_torch.text.models import ErnieMoEConfig
    cfg = dataclasses.replace(ERNIE_MOE_TINY, dtype="bfloat16")
    launches, out = chip_smoke.phase_ep(
        fa, fc, rm, ErnieMoEConfig, ErnieMoEForPretraining, fleet,
        optimizer, pt.seed, cfg=cfg, batch=(4, 128),
        workdir=str(tmp_path / "p18"))
    assert launches == chip_smoke.want_attention_launches(
        cfg.num_hidden_layers, ragged=4)
    C = -(-2 * 4 * 128 * 5 // (4 * cfg.num_experts))
    assert out["ragged_shapes"] == [[2, C, cfg.hidden_size],
                                    [2, C, cfg.intermediate_size]]
    assert out["max_rel_to_world1"] <= chip_smoke.PAIR_REL_TOL


@pytest.mark.parametrize("qblock", [64, 1024])
def test_comm_quantizer_on_the_card_is_the_cpu_one_bit_for_bit(cuda, qblock):
    """The comm-efficient exchanges' blockwise int8 quantizer (plain
    PyTorch: scale = max|x| / 127, round half to even, clip) and its
    dequantizer give on CUDA tensors what they give on the CPU, bit for
    bit: exact .5 ties, an all-zero block and random blocks."""
    from paddle_tpu_torch.distributed.fleet import comm_efficient as ce
    rng = np.random.default_rng(qblock)
    x = (rng.standard_normal((2, 8 * qblock)) * 3).astype(np.float32)
    x[0, :qblock] = np.arange(qblock) % 64 - 31.5
    x[0, 0] = 127.0                     # scale 1: x / s lands on .5
    x[1, qblock:2 * qblock] = 0.0
    nblk = x.shape[-1] // qblock
    q, s = ce._quant_blocks(torch.from_numpy(x), nblk)
    qc, sc = ce._quant_blocks(torch.from_numpy(x).to(cuda), nblk)
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    assert torch.equal(ce._dequant_blocks(qc, sc, nblk).cpu(),
                       ce._dequant_blocks(q, s, nblk))


def test_phase19_comm_efficient_dp_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 19 at LLAMA_TINY size (bf16, fused head, 4 x
    128 tokens): every arm on two gloo ranks against world 1, zero1
    bitwise the replicated flat arm, error feedback conserved and broken
    by the planted fault, rows 1-3 and 5 on ``"tc"`` every rank and
    step."""
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    cfg = dataclasses.replace(LLAMA_TINY, dtype="bfloat16",
                              fused_ce_chunk=256)
    launches, out = chip_smoke.phase_comm(
        fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet, optimizer, pt.seed,
        cfg=cfg, batch=(4, 128), workdir=str(tmp_path / "p19"))
    assert launches == chip_smoke.want_train_launches(cfg.num_hidden_layers)
    assert out["arms"]["comm_opt_int8_e1_dropped"]["fails_the_judge"]


# -- mixed precision and attention dropout (phase 21) -------------------------

def _tiny_fp32(**kw):
    return dataclasses.replace(LLAMA_TINY, dtype="float32",
                               fused_ce_chunk=256, **kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_tiny_llama_on_the_card_matches_the_cpu(cuda, dtype):
    """LLAMA_TINY with fp32 parameters under O1 with a GradScaler, 3 steps
    on a 4 x 128 batch, the card's model loaded with the CPU model's
    weights. bf16: rows 1-3 run on the tensor cores (q/k/v come out of the
    cast projections in bf16); fp16: attention takes the plain composite,
    as in JAX (the kernels take bf16 and fp32). Row 5 runs on the CUDA
    cores either way (the fused head stays fp32, as in JAX). The losses
    agree with the same steps on the CPU within 1e-2 relative (half
    precision products summed in other orders)."""
    from paddle_tpu_torch import amp
    ids = np.random.default_rng(0).integers(0, LLAMA_TINY.vocab_size,
                                            (4, 128))
    pt.seed(0)
    weights = {k: v.numpy() for k, v in LlamaForCausalLM(
        _tiny_fp32(), device="cpu").state_dict().items()}
    out = {}
    for dev in ("cpu", "cuda"):
        m = LlamaForCausalLM(_tiny_fp32(), device=dev)
        load_numpy_state_dict(m, weights)
        opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = fleet.make_train_step(m, opt, lambda mm, x, y: mm(x, labels=y),
                                     amp_level="O1", amp_dtype=dtype,
                                     scaler=amp.GradScaler())
        for f in chip_smoke._amp_counters(fa, fc).values():
            chip_smoke.reset_counts(f)
        x = torch.from_numpy(ids).to(dev)
        out[dev] = [float(step(x, x)) for _ in range(3)]
    want = chip_smoke.want_amp_launches("o1", LLAMA_TINY.num_hidden_layers)
    if dtype == "float16":
        want.update({k: {"tc": 0, "cuda_core": 0} for k in want
                     if k.startswith("flash")})
    assert chip_smoke._variant_counts(fa, fc) == {
        k: {kk: 3 * vv for kk, vv in v.items()} for k, v in want.items()}
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-2)


def test_plain_sdpa_dropout_on_the_card_matches_the_cpu(cuda):
    """The plain composite with a mask and a given keep mask gives on the
    card what it gives on the CPU (fp32, TF32 off); the card's own keep
    mask comes from the card's generator, and ``seed(n)`` repeats it."""
    from paddle_tpu_torch.nn.functional.attention import _plain_sdpa
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    mask = torch.from_numpy(rng.random((2, 1, 64, 64)) < 0.8)
    keep = torch.from_numpy(rng.random((2, 4, 64, 64)) < 0.9)
    want = _plain_sdpa(q, k, v, mask=mask, dropout_p=0.1, _keep=keep)
    got = _plain_sdpa(*(t.to(cuda) for t in (q, k, v)), mask=mask.to(cuda),
                      dropout_p=0.1, _keep=keep.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    qc, kc, vc = (t.to(cuda) for t in (q, k, v))
    pt.seed(3)
    a = F.scaled_dot_product_attention(qc, kc, vc, dropout_p=0.1)
    pt.seed(3)
    assert torch.equal(a, F.scaled_dot_product_attention(qc, kc, vc,
                                                         dropout_p=0.1))


def test_phase21a_amp_arms_at_tiny_size(cuda):
    """``chip_smoke`` phase 21a/21b at LLAMA_TINY size (fp32 parameters,
    the fused head, 4 x 128): every arm's launches by variant as
    ``want_amp_launches`` says, the bf16 arms' losses near fp32's, and the
    planted inf skipped bit for bit with the scale halved."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    launches, out = chip_smoke.phase_amp_train(
        fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer, amp,
        pt.seed, cfg=_tiny_fp32(), batch=(4, 128))
    for arm in chip_smoke.AMP_ARMS:
        assert launches[arm] == chip_smoke.want_amp_launches(
            arm, LLAMA_TINY.num_hidden_layers)
    assert out["21b"]["found_inf"] and out["21b"]["unchanged"]
    assert out["o2"]["params_dtype"] == "torch.bfloat16"


def test_phase21c_multi_head_attention_at_tiny_size(cuda):
    """``chip_smoke`` phase 21c at [2, 128, 256, 4] (head dim 64): eval on
    row 1 once (``"tc"``) within 1e-2 of the plain composite, training on
    the plain composite, the keep rate within 6 sigmas."""
    from paddle_tpu_torch import amp, nn
    out = chip_smoke.phase_mha(fa, F, nn, amp, pt.seed,
                               shape=(2, 128, 256, 4))
    assert out["eval"]["launches"] == out["eval"]["launches_tc"] == 1
    assert out["train"]["launches"] == 0


def test_phase21d_amp_tp2_at_tiny_size(cuda, tmp_path):
    """``chip_smoke`` phase 21d at LLAMA_TINY size (fp32 parameters, O1
    with a scaler, 4 x 128): two gloo ranks at tp2 against world 1, the
    inf planted on rank 1 only skipped by both."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    launches, out = chip_smoke.phase_amp_pair(
        fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer, amp,
        pt.seed, cfg=_tiny_fp32(), batch=(4, 128),
        workdir=str(tmp_path / "p21"))
    assert launches == chip_smoke.want_amp_launches(
        "o1", LLAMA_TINY.num_hidden_layers)
    assert out["skipped"] == [True, True]
    assert out["scale"][1] == out["scale"][0] / 2


# ---------------------------------------------------------------------------
# the encoder families (phase 22): each at tiny size on the card against
# the same model on the CPU, and phase 22 itself at tiny size
# ---------------------------------------------------------------------------

def _on_card(cpu_model, make, cuda):
    """A model from ``make(cuda)`` holding ``cpu_model``'s weights."""
    model = make(cuda)
    load_numpy_state_dict(model, {k: v.detach().float().numpy()
                                  for k, v in cpu_model.state_dict().items()})
    return model


def _close(got, want, tol=TOLS[torch.float32]):
    got, want = got.detach().float().cpu(), want.detach().float()
    rel = float((got - want).norm() / want.norm())
    assert rel <= tol, rel


def test_bert_tiny_on_the_card_matches_the_cpu(cuda):
    """BERT_TINY fp32 with dropout 0 at 2 x 128: unmasked the flash
    forward's fp32 variant once per layer, masked the plain composite;
    seq, pooled, the pretraining logits and the MLM + NSP loss within
    1e-4 of the CPU's."""
    from paddle_tpu_torch.text.models import bert
    cfg = dataclasses.replace(bert.BERT_TINY, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    pt.seed(0)
    cpu = bert.BertForPretraining(cfg, device="cpu")
    card = _on_card(cpu, lambda d: bert.BertForPretraining(cfg, device=d),
                    cuda)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    mask = torch.ones(2, 128, dtype=torch.long)
    mask[1, 90:] = 0
    mlm = torch.where(torch.from_numpy(rng.random((2, 128)) < 0.15), ids,
                      -100)
    nsp = torch.tensor([0, 1])
    with torch.no_grad():
        chip_smoke.reset_counts(fa.flash_attention)
        got = card.bert(ids.to(cuda))
        assert fa.flash_attention.launches == cfg.num_hidden_layers
        for g, w in zip(got, cpu.bert(ids)):
            _close(g, w)
        for g, w in zip(card(ids, attention_mask=mask),
                        cpu(ids, attention_mask=mask)):
            _close(g, w)
        assert fa.flash_attention.launches == cfg.num_hidden_layers
        _close(card(ids, attention_mask=mask, masked_lm_labels=mlm,
                    next_sentence_label=nsp),
               cpu(ids, attention_mask=mask, masked_lm_labels=mlm,
                   next_sentence_label=nsp))


@pytest.mark.parametrize("ff,tie", [("relu", True), ("gated-gelu", False)])
def test_t5_tiny_on_the_card_matches_the_cpu(cuda, ff, tie):
    """T5_TINY fp32: logits and the label loss within 1e-4 of the CPU's,
    ``generate`` token-identical, the card's bucket tables the CPU's."""
    from paddle_tpu_torch.text.models import t5
    cfg = dataclasses.replace(t5.T5_TINY, feed_forward_proj=ff,
                              tie_word_embeddings=tie)
    pt.seed(1)
    cpu = t5.T5ForConditionalGeneration(cfg, device="cpu")
    card = _on_card(cpu, lambda d: t5.T5ForConditionalGeneration(
        cfg, device=d), cuda)
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(2, 256, (3, 40)))
    tgt = torch.from_numpy(rng.integers(2, 256, (3, 24)))
    with torch.no_grad():
        _close(card(src, decoder_input_ids=tgt),
               cpu(src, decoder_input_ids=tgt))
        _close(card(src, labels=tgt), cpu(src, labels=tgt))
    assert torch.equal(card.generate(src, max_new_tokens=12).cpu(),
                       cpu.generate(src, max_new_tokens=12))
    for n, bi in ((40, True), (24, False), (13, False)):
        args = (n, n, bi, cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance)
        assert torch.equal(t5._bucket_table(*args, cuda).cpu(),
                           t5._bucket_table(*args, torch.device("cpu")))


@pytest.fixture
def no_cudnn_tf32():
    """cuDNN's convolutions in true fp32 inside the test (TF32 is its
    default; ``chip_smoke.py`` turns it off too)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def test_vit_and_conv2d_tiny_on_the_card_match_the_cpu(cuda, no_cudnn_tf32):
    """A width-64 ViT at 32 x 32 (patch 16) and a strided, grouped,
    "SAME"-padded ``Conv2D``, fp32 (TF32 off): within 1e-4 of the
    CPU's."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models import VisionTransformer
    pt.seed(2)
    kw = dict(img_size=32, embed_dim=64, depth=2, num_heads=2,
              num_classes=10)
    cpu = VisionTransformer(**kw, device="cpu")
    card = _on_card(cpu, lambda d: VisionTransformer(**kw, device=d), cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        _close(card(x), cpu(x))
        conv = nn.Conv2D(4, 8, 4, stride=2, padding="SAME", groups=2,
                         device="cpu")
        cconv = _on_card(conv, lambda d: nn.Conv2D(
            4, 8, 4, stride=2, padding="SAME", groups=2, device=d), cuda)
        _close(cconv(x[:, :1].repeat(1, 4, 1, 1).to(cuda)),
               conv(x[:, :1].repeat(1, 4, 1, 1)))


def test_phase22_at_tiny_size(cuda):
    """``chip_smoke`` phase 22 at tiny size: BERT at width 256 (head dim
    64), 2 layers, 4 x 128, lr 1e-3 (22a plain, 22b rows 1-3 once per
    layer and step against the plain-routed steps, 22c); T5_TINY (bf16
    training, fp32 untied generate); a width-64 ViT at 32 x 32."""
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.text.models import (BertConfig, BertForPretraining,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.text.models import t5 as t5mod
    from paddle_tpu_torch.vision.models import VisionTransformer
    cfg = BertConfig(vocab_size=2048, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128)
    launches, bert = chip_smoke.phase_bert(
        fa, fc, rm, F, attention, BertConfig, BertForPretraining,
        BertForSequenceClassification, fleet, optimizer, pt.seed, cfg=cfg,
        batch=(4, 128), lr=1e-3)
    assert launches["step_22b"] == chip_smoke.want_attention_launches(2)
    assert launches["forward_22c"] == {"unmasked": 2, "masked": 0}
    out = chip_smoke.phase_t5(
        fa, fc, rm, t5mod, fleet, optimizer, pt.seed,
        cfg=dataclasses.replace(t5mod.T5_TINY, dtype="bfloat16"),
        gen_cfg=dataclasses.replace(t5mod.T5_TINY,
                                    tie_word_embeddings=False),
        batch=(4, 64, 32), gen=(2, 16, 8))
    assert out["generate"]["identical_to_incremental"]

    def tiny_vit(num_classes, device):
        return VisionTransformer(img_size=32, embed_dim=64, depth=2,
                                 num_heads=2, num_classes=num_classes,
                                 device=device)
    out = chip_smoke.phase_vit(fa, fc, rm, F, tiny_vit, fleet, optimizer,
                               pt.seed, batch=(8, 32))
    assert out["attention_path"]["path"] == "plain"


def test_conv2d_fp32_on_the_card_without_the_tf32_fixture(cuda):
    """The port's fp32 ``conv2d`` pins cuDNN's TF32 off itself: with the
    process default (``allow_tf32`` True) the strided, grouped,
    "SAME"-padded ``Conv2D``'s output and both gradients are within 1e-4
    of the CPU's, and the setting is put back after the call."""
    from paddle_tpu_torch import nn
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pt.seed(2)
        conv = nn.Conv2D(4, 8, 4, stride=2, padding="SAME", groups=2,
                         device="cpu")
        cconv = _on_card(conv, lambda d: nn.Conv2D(
            4, 8, 4, stride=2, padding="SAME", groups=2, device=d), cuda)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (4, 4, 32, 32)).astype(np.float32)).requires_grad_()
        xc = x.detach().to(cuda).requires_grad_()
        y, yc = conv(x), cconv(xc)
        assert torch.backends.cudnn.allow_tf32
        _close(yc, y)
        g = torch.from_numpy(np.random.default_rng(4).standard_normal(
            tuple(y.shape)).astype(np.float32))
        y.backward(g)
        yc.backward(g.to(cuda))
        _close(xc.grad, x.grad)
        _close(cconv.weight.grad, conv.weight.grad)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _deploy_tiny():
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    pt.seed(0)
    return cfg


def _serve_staggered(server):
    """Phase 5's schedule on a tiny model's prompts, sampled per request."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 1024, n).astype(np.int32)
               for n in (20, 36, 9, 44, 17)]
    per = [dict(temperature=0.6, seed=1000 + i) for i in range(5)]
    return [list(map(int, h.tokens))
            for h in chip_smoke.staggered(server, prompts, 12, per)]


@pytest.mark.parametrize("fault", ["decode-raise", "kv-corrupt"])
def test_supervisor_replay_on_the_card_matches_the_cpu(cuda, fault):
    """A tiny fp32 Llama under ``EngineSupervisor`` with the fault at
    supervised step 3, sampled + chunked, ``flash_decode=True``: the
    card's tokens are the CPU supervisor's and the uninterrupted card
    engine's; row 4 launches once per layer per decode step summed over
    both incarnations, all on the split kernel."""
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import EngineSupervisor
    cfg = _deploy_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu").eval()
    card = _on_card(cpu, lambda d: LlamaForCausalLM(cfg, device=d), cuda)
    kw = dict(n_slots=3, max_len=128, block_size=16, flash_decode=True,
              do_sample=True, top_k=50, top_p=0.9, prefill_chunk=16)
    runs = {}
    for where, m in (("cpu", cpu), ("card", card)):
        sup = EngineSupervisor(m, chaos=ChaosMonkey(at={3: fault}),
                               kv_probe_interval=1, **kw)
        engines = chip_smoke.track_engines([sup])
        chip_smoke.reset_counts(fd.flash_decode)
        runs[where] = _serve_staggered(sup)
        assert sup.rebuilds == 1 and sup.replayed >= 1
        steps = sum(e.metrics.decode_steps for e in engines)
    want = cfg.num_hidden_layers * steps
    assert fd.flash_decode.launches == want > 0
    assert fd.flash_decode.launches_by_variant == {"split": want,
                                                   "one_pass": 0}
    assert runs["card"] == runs["cpu"] == _serve_staggered(Engine(card, **kw))


def test_fleet_migration_on_the_card_matches_the_cpu(cuda):
    """A two-replica ``ReplicaFleet`` of the tiny fp32 Llama through a
    replica kill at fleet step 3: the card's tokens and replicas are the
    CPU fleet's, its tokens the uninterrupted engine's."""
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import ReplicaFleet
    cfg = _deploy_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu").eval()
    card = _on_card(cpu, lambda d: LlamaForCausalLM(cfg, device=d), cuda)
    kw = dict(n_slots=3, max_len=128, block_size=16, flash_decode=True,
              do_sample=True, top_k=50, top_p=0.9)
    runs = {}
    for where, m in (("cpu", cpu), ("card", card)):
        fleet = ReplicaFleet(m, 2, chaos=ChaosMonkey(at={3: "replica-kill"}),
                             kv_probe_interval=1, **kw)
        runs[where] = _serve_staggered(fleet)
        assert fleet.migrations >= 1 and fleet.replica_kills == 1
    assert runs["card"] == runs["cpu"] == _serve_staggered(Engine(card, **kw))


def test_phase23_at_tiny_size(cuda):
    """``chip_smoke`` phase 23 at tiny size: a GPT at hidden 256 / 4 heads
    and LLAMA_TINY, fp32, through the artifact, the supervisor (three
    chaos faults and a real wedge, greedy and sampled + chunked) and the
    fleet."""
    from paddle_tpu_torch.inference import create_llm_predictor
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import (AdoptMismatch, EngineSupervisor,
                                          ReplicaFleet, save_lm)
    from paddle_tpu_torch.text.models.llama import LlamaConfig
    twins = (("gpt2", GPTForCausalLM, GPTConfig(
        vocab_size=1024, hidden_size=256, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=512,
        max_position_embeddings=512, dtype="float32")),
        ("llama", LlamaForCausalLM, dataclasses.replace(LLAMA_TINY,
                                                        dtype="float32")))
    launches, out = chip_smoke.phase_deploy(
        fd, Engine, EngineSupervisor, ReplicaFleet, ChaosMonkey,
        AdoptMismatch, save_lm, create_llm_predictor, LlamaConfig,
        LlamaForCausalLM, GPTConfig, GPTForCausalLM, pt.seed, twins=twins)
    assert all(v > 0 for v in launches.values())
    assert out["llama"]["23c"]["prefix_route"]["prefix_tokens"] == 64
    for what in ("gpt2", "llama"):
        for mode in ("greedy", "sampled"):
            assert out[what]["23b"][mode]["wedge"][
                "zombie_tokens_dropped"] > 0


# ---------------------------------------------------------------------------
# training robustness: checkpoint round trip and the async-save race
# ---------------------------------------------------------------------------

def _tiny_gpt_step():
    from paddle_tpu_torch.text.models import GPT_TINY
    fleet.init()
    pt.seed(0)
    cfg = dataclasses.replace(GPT_TINY, dtype="bfloat16")
    model = fleet.distributed_model(GPTForCausalLM(cfg, device="cuda"))
    step = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters())).make_train_step(
        model, lambda m, x, y: m(x, labels=y))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64))).cuda()
    return model, step, ids


def test_checkpoint_round_trip_on_the_card_is_bitwise(cuda, tmp_path):
    """A bf16 GPT train step (dropout on) saved to disk and restored into
    a fresh step: the next steps' losses and parameters bit for bit."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import TrainState
    model, step, ids = _tiny_gpt_step()
    step(ids, ids)
    mgr = CheckpointManager(tmp_path, device="cuda")
    mgr.save(0, TrainState(train_step=step).capture(), async_save=False)
    want = [float(step(ids, ids)) for _ in range(2)]
    want_p = chip_smoke.flat_params(model)
    model2, step2, _ = _tiny_gpt_step()
    state = TrainState(train_step=step2)
    at, snap = mgr.restore_latest(state.capture())
    state.restore(snap)
    assert at == 0
    assert snap["train_step"]["params"]["gpt.wte.weight"].dtype == \
        torch.bfloat16
    got = [float(step2(ids, ids)) for _ in range(2)]
    assert got == want
    assert torch.equal(chip_smoke.flat_params(model2), want_p)


def test_async_save_race_on_the_card(cuda, tmp_path):
    """Tensors on the card updated in place right after an async save (the
    next AdamW step) restore to their values at save time."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import TrainState
    model, step, ids = _tiny_gpt_step()
    step(ids, ids)
    state = TrainState(train_step=step)
    at_save = state.capture()
    mgr = CheckpointManager(tmp_path, device="cuda")
    mgr.save(0, state.capture(copy=False), async_save=True)
    for _ in range(3):
        step(ids, ids)                  # in place, while the write runs
    mgr.wait()
    _, back = mgr.restore_latest(state.capture())
    for k, t in at_save["train_step"]["params"].items():
        assert torch.equal(back["train_step"]["params"][k], t), k
    for k, st in at_save["train_step"]["opt"].items():
        for n, t in st.items():
            assert torch.equal(back["train_step"]["opt"][k][n], t), (k, n)


def test_nhwc_conv2d_fp32_on_the_card_matches_the_cpu(cuda):
    """``Conv2D(data_format="NHWC")`` in fp32 with the process default
    (cuDNN's ``allow_tf32`` True): the port pins TF32 off itself, and the
    output and both gradients are within 1e-4 of the CPU's; the output is
    the NHWC view of a ``channels_last`` result (contiguous)."""
    from paddle_tpu_torch import nn
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pt.seed(4)
        conv = nn.Conv2D(8, 16, 3, stride=2, padding=1, data_format="NHWC",
                         device="cpu")
        cconv = _on_card(conv, lambda d: nn.Conv2D(
            8, 16, 3, stride=2, padding=1, data_format="NHWC", device=d),
            cuda)
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (4, 32, 32, 8)).astype(np.float32)).requires_grad_()
        xc = x.detach().to(cuda).requires_grad_()
        y, yc = conv(x), cconv(xc)
        assert yc.shape == (4, 16, 16, 16) and yc.is_contiguous()
        _close(yc, y)
        g = torch.from_numpy(np.random.default_rng(6).standard_normal(
            tuple(y.shape)).astype(np.float32))
        y.backward(g)
        yc.backward(g.to(cuda))
        _close(xc.grad, x.grad)
        _close(cconv.weight.grad, conv.weight.grad)
        _close(cconv.bias.grad, conv.bias.grad)
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_bf16_on_the_card_matches_the_cpu(cuda, data_format):
    """A bf16 ``BatchNorm2D`` (bf16 weight, bias and buffers) in training
    and then in eval mode on the card: outputs, input gradients (of a
    seeded projection of the output: the gradient of ``sum(y²)`` through
    a batch norm with unit weight cancels to round-off) and the running
    statistics within the bf16 tolerance of the CPU's, buffers still
    bf16."""
    from paddle_tpu_torch import nn
    rng = np.random.default_rng(7)
    shape = (8, 16, 7, 7) if data_format == "NCHW" else (8, 7, 7, 16)
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 1).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        bn = nn.BatchNorm2D(16, data_format=data_format, device=dev).to(
            torch.bfloat16)
        xi = x.to(dev).clone().requires_grad_()
        y = bn(xi)
        (y.float() * g.to(dev)).sum().backward()
        bn.eval()
        outs[str(dev)] = (y, xi.grad, bn._mean, bn._variance,
                          bn(x.to(dev)))
        assert bn._mean.dtype == bn._variance.dtype == torch.bfloat16
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        _close(got, want, TOLS[torch.bfloat16])


def test_phase25_at_tiny_size(cuda):
    """``chip_smoke`` phase 25 at tiny size: ResNet-18 at batches 4 and 8
    of 64 x 64 images (and its fp32 twin at 8), ``Model`` on Cifar10 at
    batch 16, and ``Model.fit`` on BERT at width 256 (head dim 64), 2
    layers, 4 x 128: rows 1-3 once per layer and step, the losses those
    of the direct train step bit for bit."""
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig(vocab_size=2048, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128)
    launches, out = chip_smoke.phase_hapi_cnn(
        fa, fc, rm, pt.seed, resnet_kw=dict(batches=(4, 8), size=64,
                                            twin_batch=8, depth="resnet18"),
        hapi_kw=dict(batch=16), bert_cfg=cfg, bert_batch=(4, 128))
    assert launches == chip_smoke.want_attention_launches(2)
    assert out["resnet"]["channels_last"]["batch"] in (4, 8)
    assert out["hapi_resnet18"]["predict_shape"] == [256, 10]


def test_phase26_user_layer_at_reduced_width(cuda):
    """``chip_smoke`` phase 26b at reduced width (hidden 512, 4 heads of
    128, FFN 1376, [1, 256], fp32): the user's flat-op decoder layer
    against the port's ``LlamaDecoderLayer`` on the same weights, rows 1-3
    once each per call of the port's layer."""
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaDecoderLayer)
    res = chip_smoke.phase_user_layer(
        fa, fc, rm, pt, LlamaConfig, LlamaDecoderLayer,
        layer=dict(hidden=512, heads=4, ffn=1376), tokens=256, reps=2)
    assert res["launches"] == dict(flash_attention_fwd=1,
                                   flash_attention_bwd_dq=1,
                                   flash_attention_bwd_dkv=1)
    assert res["worst"][1] <= chip_smoke.P26_TOL


def test_phase26_ops_and_autograd_at_small_size(cuda):
    """Phase 26a's op table at 64 x 8 elements and 26d's probe on the card
    against the CPU."""
    counts, _ = chip_smoke.phase_eager_ops(pt, n=64)
    assert all(p == n for p, n in counts.values())
    assert max(chip_smoke.phase_autograd(pt).values()) <= \
        chip_smoke.P26D_TOL


def _flat_grads(layer):
    return torch.cat([p.grad.detach().reshape(-1).cpu()
                      for _, p in layer.named_parameters()])


def test_fp32_lstm_on_the_card_matches_the_cpu(cuda):
    """A 2-layer bidirectional fp32 LSTM with given initial states: its
    outputs, final states and every gradient on the card within 1e-5
    (relative norm) of the same layer's on the CPU, with the global TF32
    switches on (every product is a port matmul with TF32 off)."""
    import copy
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        with chip_smoke.using_device("cpu"):
            pt.seed(0)
            cpu = pt.nn.LSTM(32, 64, 2, "bidirect")
        gpu = copy.deepcopy(cpu).to(cuda)
        r = np.random.default_rng(0)
        x = r.standard_normal((4, 20, 32)).astype(np.float32)
        h0 = [r.standard_normal((4, 4, 64)).astype(np.float32)
              for _ in range(2)]
        res = []
        for layer, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
            out, (h, c) = layer(torch.from_numpy(x).to(dev),
                                tuple(torch.from_numpy(a).to(dev)
                                      for a in h0))
            (out.sum() + h.sum() + c.sum()).backward()
            res.append([t.detach().cpu() for t in (out, h, c)]
                       + [_flat_grads(layer)])
        for a, b in zip(*res):
            assert chip_smoke._rel_norm(a, b) <= 1e-5
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_fp32_conv2d_transpose_runs_without_tf32(cuda):
    """``Conv2DTranspose(64, 32, 4, 2, 1)`` in fp32 with cuDNN's TF32
    switch on: the output and both gradients within 1e-5 (relative norm)
    of the CPU's, as TF32 (a 10-bit mantissa) could not be."""
    import copy
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with chip_smoke.using_device("cpu"):
            pt.seed(1)
            cpu = pt.nn.Conv2DTranspose(64, 32, 4, 2, 1)
        gpu = copy.deepcopy(cpu).to(cuda)
        x = np.random.default_rng(1).standard_normal(
            (8, 64, 16, 16)).astype(np.float32)
        res = []
        for layer, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
            xt = torch.from_numpy(x).to(dev).requires_grad_()
            out = layer(xt)
            (out * out).sum().backward()
            res.append([out.detach().cpu(), xt.grad.cpu(),
                        _flat_grads(layer)])
        for a, b in zip(*res):
            assert chip_smoke._rel_norm(a, b) <= 1e-5
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_embedding_padding_row_gets_no_gradient_on_the_card(cuda):
    with chip_smoke.using_device("cuda"):
        pt.seed(2)
        emb = pt.nn.Embedding(100, 16, padding_idx=0)
    assert emb.weight.is_cuda and float(emb.weight[0].abs().sum()) == 0.0
    ids = torch.tensor([[0, 5, 0, 7], [3, 0, 0, 1]], device=cuda)
    out = emb(ids)
    assert float(out[0, 0].abs().sum()) == 0.0
    (out * out + out).sum().backward()
    assert float(emb.weight.grad[0].abs().sum()) == 0.0
    assert float(emb.weight.grad[5].abs().sum()) > 0.0


def test_phase28_at_small_size(cuda, monkeypatch):
    """Phase 28 at small size: 28a's table at 64 rows, 28b's seq2seq and
    28c's DCGAN at reduced widths, on the card against the CPU."""
    counts, _ = chip_smoke.phase_nn_table(pt, n=64)
    assert all(p == n for p, n in counts.values())
    monkeypatch.setattr(chip_smoke, "S2S", dict(
        src_vocab=301, trg_vocab=173, hidden=32, layers=2, dropout=0.2))
    monkeypatch.setattr(chip_smoke, "S2S_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "S2S_MAX_STEPS", 24)
    s2s = chip_smoke.phase_seq2seq(pt)
    assert s2s["twin_logits_rel"] <= chip_smoke.S2S_TWIN_TOL
    monkeypatch.setattr(chip_smoke, "DCGAN", dict(nz=16, width=64,
                                                  channels=3))
    monkeypatch.setattr(chip_smoke, "DCGAN_BATCH", 8)
    gan = chip_smoke.phase_dcgan(pt)
    assert max(gan["twin_params_rel"].values()) <= chip_smoke.DCGAN_TWIN_TOL
