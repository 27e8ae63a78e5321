"""The HuggingFace weight converters of the PyTorch port against the JAX
package's, on the CPU (no ``transformers``, no download).

HF-named state dicts are built here from numpy seeds for Llama
(``LLAMA_TINY`` at one layer, fp32), BERT (``BertModel`` at
``BERT_TINY``), T5 (``T5_TINY``: relu with tied embeddings, whose HF dict
carries ``lm_head.weight`` as an alias, and gated-gelu untied) and ViT
(32 x 32 images, patch 16, width 48, depth 2). Held:

- ``convert_hf_*_state_dict`` returns JAX's keys and arrays exactly, from
  numpy arrays and from torch tensors alike;
- ``load_hf_*_weights`` into the port's model gives JAX's forward (the
  same dict loaded into JAX's model) within ``FWD_TOL`` (1e-5);
- ``strict`` mismatches (a missing and an unexpected name) and a shape
  mismatch raise ``ValueError`` with JAX's message; ``strict=False``
  loads what matches; a tied T5 takes ``lm_head.weight`` silently;
- a planted fault must fail: q's weight loaded untransposed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as P
from paddle_tpu.text.models import bert as jbert
from paddle_tpu.text.models import convert as jconvert
from paddle_tpu.text.models import llama as jllama
from paddle_tpu.text.models import t5 as jt5
from paddle_tpu.vision.models import vit as jvit
from paddle_tpu_torch.text.models import bert, convert, llama, t5
from paddle_tpu_torch.vision.models import vit

LLAMA = dataclasses.replace(jllama.LLAMA_TINY, dtype="float32",
                            num_hidden_layers=1)
BERT = dataclasses.replace(jbert.BERT_TINY, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
T5_TIED = jt5.T5_TINY
T5_UNTIED = dataclasses.replace(jt5.T5_TINY, feed_forward_proj="gated-gelu",
                                tie_word_embeddings=False)
VIT = dict(img_size=32, patch_size=16, embed_dim=48, depth=2, num_heads=4,
           num_classes=10)
FAMILIES = ("llama", "bert", "t5_tied", "t5_untied", "vit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


class _Rand:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape, scale=0.1):
        return (scale * self.rng.standard_normal(shape)).astype(np.float32)


def _hf_llama(r):
    c = LLAMA
    h, f = c.hidden_size, c.intermediate_size
    kv = c.num_key_value_heads * h // c.num_attention_heads
    sd = {"model.embed_tokens.weight": r(c.vocab_size, h),
          "model.norm.weight": 1 + r(h), "lm_head.weight": r(c.vocab_size, h)}
    for i in range(c.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": r(h, h),
                   p + "self_attn.k_proj.weight": r(kv, h),
                   p + "self_attn.v_proj.weight": r(kv, h),
                   p + "self_attn.o_proj.weight": r(h, h),
                   p + "self_attn.rotary_emb.inv_freq": r(h // 16),
                   p + "mlp.gate_proj.weight": r(f, h),
                   p + "mlp.up_proj.weight": r(f, h),
                   p + "mlp.down_proj.weight": r(h, f),
                   p + "input_layernorm.weight": 1 + r(h),
                   p + "post_attention_layernorm.weight": 1 + r(h)})
    return sd


def _hf_bert(r):
    c = BERT
    h, f = c.hidden_size, c.intermediate_size
    sd = {"bert.embeddings.word_embeddings.weight": r(c.vocab_size, h),
          "bert.embeddings.position_embeddings.weight":
              r(c.max_position_embeddings, h),
          "bert.embeddings.token_type_embeddings.weight":
              r(c.type_vocab_size, h),
          "bert.embeddings.LayerNorm.weight": 1 + r(h),
          "bert.embeddings.LayerNorm.bias": r(h),
          "bert.pooler.dense.weight": r(h, h),
          "bert.pooler.dense.bias": r(h)}
    for i in range(c.num_hidden_layers):
        p = f"bert.encoder.layer.{i}."
        for n, (o, k) in {"attention.self.query": (h, h),
                          "attention.self.key": (h, h),
                          "attention.self.value": (h, h),
                          "attention.output.dense": (h, h),
                          "intermediate.dense": (f, h),
                          "output.dense": (h, f)}.items():
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(o, k), r(o)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + r(h), r(h)
    return sd


def _hf_t5(r, c):
    d, inner, f = c.d_model, c.num_heads * c.d_kv, c.d_ff
    sd = {"shared.weight": r(c.vocab_size, d, scale=1.0),
          "encoder.embed_tokens.weight": r(c.vocab_size, d),
          "decoder.embed_tokens.weight": r(c.vocab_size, d),
          "encoder.final_layer_norm.weight": 1 + r(d),
          "decoder.final_layer_norm.weight": 1 + r(d),
          "lm_head.weight": r(c.vocab_size, d)}

    def attn(p):
        for n in "qkv":
            sd[f"{p}.{n}.weight"] = r(inner, d)
        sd[f"{p}.o.weight"] = r(d, inner)

    def ff(p):
        for n in (("wi_0", "wi_1") if c.feed_forward_proj.startswith("gated")
                  else ("wi",)):
            sd[f"{p}.DenseReluDense.{n}.weight"] = r(f, d)
        sd[f"{p}.DenseReluDense.wo.weight"] = r(d, f)
        sd[f"{p}.layer_norm.weight"] = 1 + r(d)

    for stack, n in (("encoder", c.num_layers),
                     ("decoder", c.num_decoder_layers)):
        for i in range(n):
            p = f"{stack}.block.{i}.layer"
            attn(f"{p}.0.SelfAttention")
            sd[f"{p}.0.layer_norm.weight"] = 1 + r(d)
            if i == 0:
                sd[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = \
                    r(c.relative_attention_num_buckets, c.num_heads)
            if stack == "decoder":
                attn(f"{p}.1.EncDecAttention")
                sd[f"{p}.1.layer_norm.weight"] = 1 + r(d)
                ff(f"{p}.2")
            else:
                ff(f"{p}.1")
    return sd


def _hf_vit(r):
    e, n = VIT["embed_dim"], (VIT["img_size"] // VIT["patch_size"]) ** 2
    p16 = VIT["patch_size"]
    sd = {"vit.embeddings.cls_token": r(1, 1, e),
          "vit.embeddings.position_embeddings": r(1, n + 1, e),
          "vit.embeddings.patch_embeddings.projection.weight":
              r(e, 3, p16, p16, scale=0.02),
          "vit.embeddings.patch_embeddings.projection.bias": r(e),
          "vit.layernorm.weight": 1 + r(e), "vit.layernorm.bias": r(e),
          "vit.pooler.dense.weight": r(e, e), "vit.pooler.dense.bias": r(e),
          "classifier.weight": r(VIT["num_classes"], e),
          "classifier.bias": r(VIT["num_classes"])}
    for i in range(VIT["depth"]):
        p = f"vit.encoder.layer.{i}."
        for name, (o, k) in {"attention.attention.query": (e, e),
                             "attention.attention.key": (e, e),
                             "attention.attention.value": (e, e),
                             "attention.output.dense": (e, e),
                             "intermediate.dense": (4 * e, e),
                             "output.dense": (e, 4 * e)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = r(o, k), r(o)
        for name in ("layernorm_before", "layernorm_after"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = \
                1 + r(e), r(e)
    return sd


def _family(name):
    """(HF dict, JAX model maker, port model maker, JAX converter, port
    converter, JAX loader, port loader, inputs, JAX call, port call)."""
    r = _Rand(FAMILIES.index(name))
    rng = np.random.default_rng(10)
    if name == "llama":
        ids = rng.integers(0, LLAMA.vocab_size, (2, 16))
        return (_hf_llama(r), lambda: jllama.LlamaForCausalLM(LLAMA),
                lambda: llama.LlamaForCausalLM(
                    llama.LlamaConfig(**dataclasses.asdict(LLAMA)),
                    device="cpu"), "llama", (ids,),
                lambda m, i: m(i), lambda m, i: m(i))
    if name == "bert":
        ids = rng.integers(0, BERT.vocab_size, (2, 16))
        return (_hf_bert(r), lambda: jbert.BertModel(BERT),
                lambda: bert.BertModel(
                    bert.BertConfig(**dataclasses.asdict(BERT)),
                    device="cpu"), "bert", (ids,),
                lambda m, i: m(i)[0], lambda m, i: m(i)[0])
    if name.startswith("t5"):
        c = T5_TIED if name == "t5_tied" else T5_UNTIED
        src, dec = (rng.integers(0, 256, (2, n)) for n in (10, 6))
        return (_hf_t5(r, c), lambda: jt5.T5ForConditionalGeneration(c),
                lambda: t5.T5ForConditionalGeneration(
                    t5.T5Config(**dataclasses.asdict(c)), device="cpu"),
                "t5", (src, dec),
                lambda m, s, d: m(s, decoder_input_ids=d),
                lambda m, s, d: m(s, decoder_input_ids=d))
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    return (_hf_vit(r), lambda: jvit.VisionTransformer(**VIT),
            lambda: vit.VisionTransformer(**VIT, device="cpu"), "vit", (x,),
            lambda m, x: m(x), lambda m, x: m(torch.from_numpy(x)))


@pytest.fixture(scope="module")
def jax_models():
    """family -> (JAX model with the HF weights loaded, its forward on
    the family's inputs)."""
    out = {}
    for name in FAMILIES:
        hf, make_jax, _, kind, inputs, jcall, _ = _family(name)
        with P.constant_init():
            jm = make_jax()
        jm = getattr(jconvert, f"load_hf_{kind}_weights")(jm, hf)
        jin = [a.astype(np.int32) if a.dtype.kind == "i" else a
               for a in inputs]
        out[name] = (jm, P.jax_call(lambda *a: jcall(jm, *a), *jin))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_converter_returns_jax_keys_and_arrays(name):
    hf, *_, kind, _, _, _ = _family(name)
    want = getattr(jconvert, f"convert_hf_{kind}_state_dict")(hf)
    for src in (hf, {k: torch.from_numpy(np.asarray(v))
                     for k, v in hf.items()}):
        got = getattr(convert, f"convert_hf_{kind}_state_dict")(src)
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_loaded_model_matches_jax_forward(jax_models, name):
    hf, _, make_port, kind, inputs, _, pcall = _family(name)
    tm = getattr(convert, f"load_hf_{kind}_weights")(make_port(), hf)
    with torch.no_grad():
        got = pcall(tm, *inputs)
    np.testing.assert_allclose(got.numpy(), jax_models[name][1],
                               **P.FWD_TOL)


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("name", FAMILIES)
def test_mismatches_raise_as_jax(jax_models, name):
    hf, _, make_port, kind, _, _, _ = _family(name)
    jm = jax_models[name][0]
    jload = getattr(jconvert, f"load_hf_{kind}_weights")
    pload = getattr(convert, f"load_hf_{kind}_weights")
    tm = make_port()
    first = next(k for k in hf if k in (
        "model.embed_tokens.weight", "bert.embeddings.word_embeddings.weight",
        "shared.weight", "vit.embeddings.cls_token"))
    missing = {k: v for k, v in hf.items() if k != first}
    # a block the model lacks: every converter passes it through
    unexpected = dict(hf, **{"encoder.block.9.layer.0.layer_norm.weight":
                             np.zeros(3, np.float32)})
    if name == "t5_tied":     # the tied head's alias is taken silently
        pload(tm, hf)
    for bad in (missing, unexpected):
        msg = _raises(lambda: jload(jm, bad))
        assert "state dict mismatch" in msg
        assert _raises(lambda: pload(tm, bad)) == msg
        pload(tm, bad, strict=False)
    resized = dict(hf)
    resized[first] = np.zeros((3, 5), np.float32)
    msg = _raises(lambda: jload(jm, resized, strict=False))
    assert "shape" in msg
    assert _raises(lambda: pload(tm, resized, strict=False)) == msg


def test_planted_fault_untransposed_q_fails(jax_models):
    """BERT's q weight left in HF's [out, in] layout (square, so it loads)
    must break the forward's check."""
    hf, _, make_port, _, inputs, _, pcall = _family("bert")
    conv = convert.convert_hf_bert_state_dict(hf)
    k = "encoder.layers.0.self_attn.q_proj.weight"
    conv[k] = conv[k].T
    tm = make_port()
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    load_numpy_state_dict(tm, conv)
    with torch.no_grad():
        got = pcall(tm, *inputs)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), jax_models["bert"][1],
                                   **P.FWD_TOL)
