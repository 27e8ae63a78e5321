"""GPT of the PyTorch port against the JAX package.

``GPT_TINY`` (2 layers, hidden 128, 4 heads of 32) in fp32 is built in the
JAX package, put in eval mode (dropout off) and carried into the port
through numpy (``load_numpy_state_dict``); the state dicts have the same
keys, shapes and dtypes. Both then compute the same logits and loss
(within 1e-4), the same per-layer bodies (prefill, slot decode, paged
decode with ``flash`` off and on -- the JAX side's Pallas kernel in
interpret mode -- and the prefill chunk, within 1e-5, the K/V they write
too) and the same ``gpt_generate`` tokens (greedy, sampled top-k/top-p
from a seed, right-padded prompts, eos). ``max_new_tokens=0`` is refused
on both sides. The bf16 flash forward takes its tensor-core variant on
GPT's q/k/v, strided views of the fused projection.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.text import generation as JG
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text import generation as G
from paddle_tpu_torch.text.models import gpt as tgpt
from paddle_tpu_torch.text.models import GPT_TINY, GPTConfig, GPTForCausalLM

V = GPT_TINY.vocab_size
H = GPT_TINY.num_attention_heads
HD = GPT_TINY.hidden_size // H
# fp32 on both sides: the logits and loss differ only in sum order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# one layer's output and the K/V it writes, fp32: sum order only
BODY_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPT_TINY)
    jm.eval()
    tm = GPTForCausalLM(GPT_TINY, device="cpu")
    tm.eval()
    load_numpy_state_dict(tm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def test_configs_match_the_jax_package():
    tiny = dataclasses.asdict(tgpt.GPT_TINY)
    assert tiny.pop("dtype") == "float32"          # the port's own field
    assert tiny == dataclasses.asdict(jgpt.GPT_TINY)
    default = dataclasses.asdict(GPTConfig())
    default.pop("dtype")
    assert default == dataclasses.asdict(jgpt.GPTConfig())
    assert default == dict(vocab_size=50304, hidden_size=768,
                           num_hidden_layers=12, num_attention_heads=12,
                           intermediate_size=3072,
                           max_position_embeddings=1024, dropout=0.1)


def test_state_dict_keys_shapes_and_dtypes_match(models):
    jm, tm = models
    want = {k: (tuple(v.shape), str(_np(v).dtype))
            for k, v in jm.state_dict().items()}
    got = {k: (tuple(v.shape), str(v.detach().numpy().dtype))
           for k, v in tm.state_dict().items()}
    assert got == want
    assert len(got) == 4 + 12 * GPT_TINY.num_hidden_layers + 1


def test_weights_carry_across_unchanged(models):
    jm, tm = models
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _np(jm.state_dict()[k]),
                                      err_msg=k)
    # every body weight is a view of the module's parameter: no copy
    w = G.gpt_layer_weights(tm)
    assert w["layers"][1]["wqkv"] is tm.gpt.blocks[1].qkv.weight
    assert w["head"] is tm.lm_head.weight and w["wpe"] is tm.gpt.wpe.weight


@pytest.mark.parametrize("B,L", [(2, 16), (1, 128)])
def test_forward_logits_and_loss_match(models, B, L):
    jm, tm = models
    ids = np.random.default_rng(L).integers(0, V, (B, L)).astype(np.int32)
    want = _np(jm(paddle.to_tensor(ids)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    want_loss = float(_np(jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(ids))))
    got_loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert got_loss.dtype == torch.float32 and got_loss.dim() == 0
    np.testing.assert_allclose(got_loss.item(), want_loss, **LOGIT_TOL)


def test_dropout_follows_train_mode(models):
    _, tm = models
    ids = torch.arange(12)[None]
    with torch.inference_mode():
        ref = tm(ids)
        tm.train()
        try:
            noisy = tm(ids)
        finally:
            tm.eval()
    assert not torch.equal(ref, noisy)


def _layer(jm, tm, l):
    jw = JG._gpt_stacked_weights(jm)
    return ({k: jw[k][l] for k in JG._GPT_STACK_KEYS},
            G.gpt_layer_weights(tm)["layers"][l])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_prefill_layer_matches(models):
    jm, tm = models
    jl, tl = _layer(jm, tm, 1)
    x = np.random.default_rng(0).standard_normal(
        (2, 12, GPT_TINY.hidden_size)).astype(np.float32)
    jx, (jk, jv) = JG._gpt_prefill_layer(jnp.asarray(x), jl, n_heads=H)
    with torch.inference_mode():
        tx, (tk, tv) = G._gpt_prefill_layer(_t(x), tl, n_heads=H)
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BODY_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_slot_decode_layer_matches(models, masked):
    jm, tm = models
    jl, tl = _layer(jm, tm, 0)
    rng = np.random.default_rng(1)
    B, T = 3, 10
    xt = rng.standard_normal((B, 1, GPT_TINY.hidden_size)).astype(np.float32)
    kc = rng.standard_normal((B, T, H, HD)).astype(np.float32)
    vc = rng.standard_normal((B, T, H, HD)).astype(np.float32)
    widx = np.array([0, 4, 9], np.int32)
    mask = rng.random((B, T)) < 0.7 if masked else None
    if masked:
        mask[:, 0] = True
    jx, jk, jv = JG._gpt_decode_layer(
        jnp.asarray(xt), jl, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(widx), None if mask is None else jnp.asarray(mask),
        n_heads=H)
    tk, tv = _t(kc.copy()), _t(vc.copy())
    with torch.inference_mode():
        tx = G._gpt_decode_layer(_t(xt), tl, tk, tv, _t(widx).long(),
                                 None if mask is None else _t(mask),
                                 n_heads=H)
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BODY_TOL)


def _pool_case(rng, S=3, nb=9, bs=4, mb=3):
    kc = rng.standard_normal((nb, bs, H, HD)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, H, HD)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                       for _ in range(S)]).astype(np.int32)
    return kc, vc, tables


@pytest.mark.parametrize("flash", [False, True])
def test_paged_decode_layer_matches(models, flash):
    """The paged body with the gathered attention and with the flash-decode
    path (the JAX Pallas kernel in interpret mode; the port's plain
    version on the CPU); an inactive row writes into the trash block."""
    jm, tm = models
    jl, tl = _layer(jm, tm, 1)
    rng = np.random.default_rng(2)
    kc, vc, tables = _pool_case(rng)
    bs = kc.shape[1]
    S = tables.shape[0]
    xt = rng.standard_normal((S, 1, GPT_TINY.hidden_size)).astype(np.float32)
    wp = np.array([0, 6, 11], np.int32)
    active = np.array([True, True, False])
    dest = np.where(active, tables[np.arange(S), wp // bs] * bs + wp % bs,
                    wp % bs).astype(np.int32)
    jx, jk, jv = JG._gpt_decode_layer_paged(
        jnp.asarray(xt), jl, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(dest), jnp.asarray(wp), n_heads=H,
        block_size=bs, flash_decode=flash)
    tk, tv = _t(kc.copy()), _t(vc.copy())
    with torch.inference_mode():
        tx = G._gpt_decode_layer_paged(_t(xt), tl, tk, tv, _t(tables),
                                       _t(dest).long(), _t(wp), n_heads=H,
                                       flash_decode=flash)
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BODY_TOL)


def test_chunk_layer_matches(models):
    """A middle chunk of one slot: an earlier chunk's K/V already in its
    blocks, pad and shared positions redirected into the trash block."""
    jm, tm = models
    jl, tl = _layer(jm, tm, 0)
    rng = np.random.default_rng(3)
    kc, vc, tables = _pool_case(rng, S=1, nb=9, bs=4, mb=4)
    bs, C = 4, 8
    row = tables[0]
    gpos = (4 + np.arange(C)).astype(np.int32)          # chunk start 4
    n_prompt, skip_write = 10, 6
    writable = (gpos >= skip_write) & (gpos < n_prompt)
    wdest = np.where(writable, row[gpos // bs] * bs + gpos % bs,
                     gpos % bs).astype(np.int32)
    x = rng.standard_normal((1, C, GPT_TINY.hidden_size)).astype(np.float32)
    jx, jk, jv = JG._gpt_chunk_layer(
        jnp.asarray(x), jl, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(row), jnp.asarray(gpos), jnp.asarray(wdest), n_heads=H,
        block_size=bs)
    tk, tv = _t(kc.copy()), _t(vc.copy())
    with torch.inference_mode():
        tx = G._gpt_chunk_layer(_t(x), tl, tk, tv, _t(row), _t(gpos).long(),
                                _t(wdest).long(), n_heads=H, block_size=bs)
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BODY_TOL)


def _prompts():
    rng = np.random.default_rng(5)
    return rng.integers(1, V, (3, 9)).astype(np.int32)


# name -> gpt_generate arguments; each compiles one JAX program. "eos"
# also stops on the greedy run's third token of row 0 (``_gen_kwargs``).
GEN_CASES = {
    "greedy": dict(max_new_tokens=7),
    "sampled": dict(max_new_tokens=7, do_sample=True, top_k=20, top_p=0.9,
                    temperature=0.8, seed=5),
    "right-padded": dict(max_new_tokens=6, pad_token_id=0),
    "eos": dict(max_new_tokens=8),
}


def _gen_kwargs(name, greedy=None):
    kw = GEN_CASES[name]
    return dict(kw, eos_token_id=int(greedy[0, 11])) if name == "eos" else kw


def _padded(ids):
    ids = ids.copy()
    ids[0, 6:] = 0                        # row 0 has 6 real tokens
    ids[2, 8:] = 0
    return ids


@pytest.fixture(scope="module")
def jax_generated(models):
    jm, _ = models
    ids = _prompts()
    out = {}
    for name in GEN_CASES:
        x = _padded(ids) if name == "right-padded" else ids
        out[name] = _np(jm.generate(paddle.to_tensor(x),
                                    **_gen_kwargs(name, out.get("greedy"))))
    return out


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_gpt_generate_tokens_match_jax(models, jax_generated, name):
    _, tm = models
    ids = _prompts()
    x = _padded(ids) if name == "right-padded" else ids
    kw = _gen_kwargs(name, jax_generated["greedy"])
    got = tm.generate(torch.from_numpy(x), **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_generated[name])
    assert torch.equal(got, G.gpt_generate(tm, torch.from_numpy(x), **kw))


def test_generate_with_an_attention_mask_matches_jax(models):
    jm, tm = models
    ids = _prompts()
    am = np.ones_like(ids)
    am[1, 5:] = 0
    want = _np(jm.generate(paddle.to_tensor(ids), max_new_tokens=4,
                           attention_mask=paddle.to_tensor(am)))
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=4,
                      attention_mask=torch.from_numpy(am))
    np.testing.assert_array_equal(got.numpy(), want)


def test_max_new_tokens_zero_is_refused_on_both_sides(models):
    """The JAX package's GPT generation fails on it (its first token has
    nowhere to go: an IndexError inside the jitted program); the port
    raises ValueError, as its Llama ``generate`` does."""
    jm, tm = models
    ids = _prompts()
    with pytest.raises(IndexError):
        jm.generate(paddle.to_tensor(ids), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(torch.from_numpy(ids), max_new_tokens=0)


def test_generate_refuses_positions_past_the_table(models):
    _, tm = models
    P = GPT_TINY.max_position_embeddings
    ids = torch.zeros((1, P - 3), dtype=torch.long)
    assert tm.generate(ids, max_new_tokens=4).shape == (1, P + 1)
    with pytest.raises(ValueError, match="position table"):
        tm.generate(ids, max_new_tokens=5)


def test_bf16_flash_forward_takes_the_tensor_cores_on_gpt_views():
    """GPT's q/k/v are views of the fused qkv projection (row stride 3h,
    k and v at element offsets h and 2h): the bf16 forward's variant rule
    takes them to the tensor-core kernel as they are, no copy."""
    B, L, h = 1, 256, 768
    qkv = torch.zeros(B, L, 3 * h, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, L, 12, 64) for t in qkv.split(h, dim=-1))
    base = qkv.data_ptr()
    assert [t.data_ptr() - base for t in (q, k, v)] == [0, 2 * h, 4 * h]
    assert q.stride() == (L * 3 * h, 3 * h, 64, 1)
    assert fa._variant(q, k, v) == "tc"
    assert fa._variant(q.float(), k.float(), v.float()) == "cuda_core"
