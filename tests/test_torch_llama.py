"""Llama of the PyTorch port against the JAX package.

The two packages share parameter names and layouts: a JAX
``LlamaForCausalLM``'s state dict carries into the port through numpy
(``load_numpy_state_dict``) and both then compute the same logits
(fp32, within 1e-4), with an untied and a tied head.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.text.models.llama import (LLAMA_TINY, LlamaConfig,
                                                LlamaForCausalLM)
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")


def _jax_model(tie=False):
    paddle.seed(0)
    m = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                     tie_word_embeddings=tie))
    m.eval()
    return m


def _arrays(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def test_configs_match_the_jax_package():
    from paddle_tpu.text.models import llama as jl
    from paddle_tpu_torch.text.models import llama as tl
    for name in ("LLAMA2_7B", "LLAMA2_13B", "LLAMA_TINY"):
        assert dataclasses.asdict(getattr(tl, name)) == \
            dataclasses.asdict(getattr(jl, name))


@pytest.mark.parametrize("tie", [False, True])
def test_state_dict_keys_and_shapes_match(tie):
    jm = _jax_model(tie)
    tm = LlamaForCausalLM(dataclasses.replace(CFG, tie_word_embeddings=tie),
                          device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert len(got) == (20 if tie else 21)       # 2 layers


@pytest.mark.parametrize("tie", [False, True])
def test_forward_logits_match_after_weight_carry(tie):
    jm = _jax_model(tie)
    tm = LlamaForCausalLM(dataclasses.replace(CFG, tie_word_embeddings=tie),
                          device="cpu")
    load_numpy_state_dict(tm, _arrays(jm))
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.inference_mode():            # scoring, as the engine runs
        got = tm(ids)
    assert got.dtype == torch.float32 and got.shape == (2, 24,
                                                        CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_load_rejects_key_and_shape_mismatch():
    jm = _jax_model()
    tm = LlamaForCausalLM(CFG, device="cpu")
    arrays = _arrays(jm)
    before = tm.llama.norm.weight.clone()
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_numpy_state_dict(tm, {k: v for k, v in arrays.items()
                                   if k != "lm_head.weight"})
    bad = dict(arrays)
    bad["llama.norm.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="llama.norm.weight"):
        load_numpy_state_dict(tm, bad)
    assert torch.equal(tm.llama.norm.weight, before)   # nothing written


def test_seeded_init_is_reproducible_and_training_options_raise():
    import paddle_tpu_torch as pt
    pt.seed(3)
    a = LlamaForCausalLM(CFG, device="cpu")
    pt.seed(3)
    b = LlamaForCausalLM(CFG, device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    # sequence parallel runs since the sequence-parallel slice
    # (tests/test_torch_sep_train.py); beside tp the JAX guard refuses it
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet.placement import place_model
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        place_model(LlamaForCausalLM(LlamaConfig(
            **{**dataclasses.asdict(CFG), "sequence_parallel": True}),
            device="cpu"), mesh.build_mesh(sep=2, tp=2, world_size=4,
                                           rank=0), 0)
    with pytest.raises(ValueError, match="remat"):
        LlamaForCausalLM(dataclasses.replace(CFG, remat="some"),
                         device="cpu")
    # the training options of the slice run: labels give the next-token
    # CE, the same through the dense and the fused head
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 16))
    dense = a(ids, labels=ids)
    b.config = dataclasses.replace(CFG, fused_ce_chunk=300)
    fused = b(ids, labels=ids)
    assert dense.shape == () and dense.dtype == torch.float32
    torch.testing.assert_close(fused, dense, atol=1e-5, rtol=1e-5)
    dense.backward()
    assert a.lm_head.weight.grad is not None
