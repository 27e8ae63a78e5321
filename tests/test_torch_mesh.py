"""The port's placement rules against the JAX package's.

``paddle_tpu_torch.distributed.mesh`` ports ``infer_param_pspec``,
``data_pspec`` and the train step's ``_opt_state_pspec`` as plain
functions over tuples. For every parameter and optimizer-state shape of
``LLAMA_TINY`` and ``LLAMA2_7B`` (one decoder layer stands for all:
they are alike) and each (dp, sharding, tp, stage) below, the port's
specs must equal the JAX functions' exactly, the JAX side run on the
8 virtual CPU devices of ``tests/conftest.py``. A rank's coordinates
must be its device's position in the JAX ``build_mesh`` array, and the
port model's tp annotations the JAX model's.
"""
import dataclasses

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.distributed.fleet.train_step import _opt_state_pspec
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.text.models.llama import (LLAMA2_7B, LLAMA_TINY,
                                                LlamaForCausalLM)

# (dp, sharding, tp, sharding stage)
MESHES = [(4, 1, 1, 0), (1, 4, 1, 1), (1, 4, 1, 2), (1, 4, 1, 3),
          (1, 1, 2, 0), (2, 2, 2, 3)]
CONFIGS = {"tiny": LLAMA_TINY, "7b": LLAMA2_7B}
ADAMW_LEAVES = ("moment1", "moment2", "master")    # shaped like the param


def _param_shapes(c):
    """name -> shape of a Llama with one decoder layer (the others are
    alike), from the config's widths."""
    h, f, v = c.hidden_size, c.intermediate_size, c.vocab_size
    kv = c.num_key_value_heads * (h // c.num_attention_heads)
    layer = {"input_layernorm.weight": (h,),
             "self_attn.q_proj.weight": (h, h),
             "self_attn.k_proj.weight": (h, kv),
             "self_attn.v_proj.weight": (h, kv),
             "self_attn.o_proj.weight": (h, h),
             "post_attention_layernorm.weight": (h,),
             "mlp.gate_proj.weight": (h, f), "mlp.up_proj.weight": (h, f),
             "mlp.down_proj.weight": (f, h)}
    out = {"llama.embed_tokens.weight": (v, h), "llama.norm.weight": (h,),
           "lm_head.weight": (h, v)}
    out.update({f"llama.layers.0.{k}": s for k, s in layer.items()})
    return out


@pytest.fixture(scope="module")
def tp_specs():
    """name -> the port model's tp annotation, checked equal to the JAX
    model's."""
    cfg = dataclasses.replace(LLAMA_TINY, num_hidden_layers=1,
                              dtype="float32")
    port = {k: getattr(p, "pspec", None) for k, p in
            LlamaForCausalLM(cfg, device="cpu").named_parameters()}
    jm = JaxLlama(dataclasses.replace(JAX_TINY, num_hidden_layers=1,
                                      dtype="float32"))
    want = {k: (tuple(p.pspec) if p.pspec is not None else None)
            for k, p in jm.named_parameters()}
    assert port == want
    shapes = _param_shapes(cfg)
    assert shapes == {k: tuple(p.shape) for k, p in
                      LlamaForCausalLM(cfg, device="cpu").named_parameters()}
    return port


def _meshes(dp, sharding, tp):
    jax_mesh.set_mesh(jax_mesh.build_mesh(dp=dp, tp=tp, sharding=sharding))
    return mesh.build_mesh(dp=dp, tp=tp, sharding=sharding, world_size=8,
                           rank=0)


@pytest.fixture(autouse=True)
def _no_jax_mesh_left():
    yield
    jax_mesh.set_mesh(None)


@pytest.mark.parametrize("model", sorted(CONFIGS))
@pytest.mark.parametrize("dp,sharding,tp,stage", MESHES)
def test_param_specs_equal_jax(tp_specs, model, dp, sharding, tp, stage):
    m = _meshes(dp, sharding, tp)
    for name, shape in _param_shapes(CONFIGS[model]).items():
        ann = tp_specs[name]
        want = jax_mesh.infer_param_pspec(shape, P(*ann) if ann else None,
                                          stage)
        got = mesh.infer_param_pspec(shape, ann, stage, mesh=m)
        assert got == tuple(want), (name, got, want)


@pytest.mark.parametrize("model", sorted(CONFIGS))
@pytest.mark.parametrize("dp,sharding,tp,stage", MESHES)
def test_opt_state_specs_equal_jax(tp_specs, model, dp, sharding, tp,
                                   stage):
    m = _meshes(dp, sharding, tp)
    for name, shape in _param_shapes(CONFIGS[model]).items():
        ann = tp_specs[name]
        pspec = mesh.infer_param_pspec(shape, ann, stage, mesh=m)
        jspec = jax_mesh.infer_param_pspec(shape, P(*ann) if ann else None,
                                           stage)
        for leaf in [shape] * len(ADAMW_LEAVES) + [()]:
            want = _opt_state_pspec(jspec, leaf, shape, stage)
            got = mesh.opt_state_pspec(pspec, leaf, shape, stage, mesh=m)
            assert got == tuple(want), (name, leaf, got, want)


@pytest.mark.parametrize("dp,sharding,tp,stage", MESHES)
def test_data_specs_equal_jax(dp, sharding, tp, stage):
    m = _meshes(dp, sharding, tp)
    for shape in [(8, 32), (8,), (6, 32), (2, 2048), (16, 2048, 3), ()]:
        assert mesh.data_pspec(shape, mesh=m) == \
            tuple(jax_mesh.data_pspec(shape)), shape


@pytest.mark.parametrize("dp,sharding,tp,stage", MESHES)
def test_rank_coordinates_follow_the_jax_device_array(dp, sharding, tp,
                                                      stage):
    jm = jax_mesh.build_mesh(dp=dp, tp=tp, sharding=sharding)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    n = ids.size
    for r in range(n):
        m = mesh.build_mesh(dp=dp, tp=tp, sharding=sharding, world_size=8,
                            rank=r)
        pos = tuple(m.coords[a] for a in mesh.AXES)
        assert ids[pos] == r
        for axis in ("dp", "sharding", "tp"):
            idx = tuple(slice(None) if a == axis else pos[i]
                        for i, a in enumerate(jax_mesh.AXES))
            assert m.axis_ranks(axis) == list(ids[idx])
    assert mesh.build_mesh(dp=dp, tp=tp, sharding=sharding, world_size=8,
                           rank=n).coords is None
