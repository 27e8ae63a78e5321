"""The deployment artifact of the PyTorch port against the JAX package's.

``serving.save_lm`` -> ``inference.create_llm_predictor`` across the two
packages: an fp32 artifact written by the JAX package serves, through the
port's predictor, the JAX source engine's tokens, and one written by the
port serves them through the JAX predictor, on LLAMA_TINY and GPT_TINY,
greedy and sampled. The port's bf16 round trip is bit for bit; a
JAX-written bf16 artifact reads where ``ml_dtypes`` imports and names it
where it does not. The ``Predictor`` / ``_Handle`` surface answers as the
JAX one does (``tests/test_inference_predictor.py``), on a JAX artifact
that carries StableHLO too, which the port loads for its weights and
refuses to run. The refusals (``input_spec=``, ``precompile``, an AOT
geometry, calling a graph-less artifact, a foreign pickle global) raise.
Two planted faults (the bf16 record dropped, two layers' weights swapped)
must each break an identity.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import serving as jsrv
from paddle_tpu.static import InputSpec
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu.text.models.llama import LLAMA_TINY as JAX_TINY
from paddle_tpu.text.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.jit import serialization as tser
from paddle_tpu_torch.serving import Engine, save_lm
from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM
from paddle_tpu_torch.text.models.llama import LLAMA_TINY, LlamaForCausalLM

GEO = dict(n_slots=2, max_len=64, min_prompt_bucket=4)
SAMPLED = dict(do_sample=True, top_k=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_model(arch):
    paddle.seed(0)
    if arch == "llama":
        m = JaxLlama(dataclasses.replace(JAX_TINY, dtype="float32",
                                         num_hidden_layers=2))
    else:
        m = jgpt.GPTForCausalLM(jgpt.GPT_TINY)
    m.eval()
    return m


def _port_model(arch, jm=None):
    if arch == "llama":
        m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY, dtype="float32",
                                                 num_hidden_layers=2),
                             device="cpu")
    else:
        m = GPTForCausalLM(GPT_TINY, device="cpu")
    if jm is not None:
        load_numpy_state_dict(m, {k: np.asarray(v._data)
                                  for k, v in jm.state_dict().items()})
    return m.eval()


def _serve(engine, vocab, sampled):
    """Three staggered requests, one of them queued; the tokens."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (5, 9, 6)]
    kw = [dict(max_new_tokens=6, temperature=0.8 + 0.2 * i, seed=10 + i)
          if sampled else dict(max_new_tokens=6) for i in range(3)]
    hs = [engine.submit(prompts[0], **kw[0])]
    engine.step()
    hs += [engine.submit(p, **k) for p, k in zip(prompts[1:], kw[1:])]
    while any(not h.finished for h in hs):
        engine.step()
    return [list(map(int, h.tokens)) for h in hs]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("llama", "gpt"):
        jm = _jax_model(arch)
        out[arch] = (jm, _port_model(arch, jm))
    return out


# ---------------------------------------------------------------------------
# the artifact across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "gpt"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_jax_artifact_serves_through_the_port(models, tmp_path, arch,
                                              sampled):
    jm, tm = models[arch]
    vocab = tm.config.vocab_size
    kw = dict(GEO, **(SAMPLED if sampled else {}))
    path = jsrv.save_lm(jm, str(tmp_path / "lm"))
    want = _serve(jsrv.Engine(jm, **kw), vocab, sampled)
    pred = inference.create_llm_predictor(path, device="cpu", **kw)
    assert pred.engine.device.type == "cpu"
    assert _serve(pred.engine, vocab, sampled) == want
    assert _serve(Engine(tm, **kw), vocab, sampled) == want


@pytest.mark.parametrize("arch", ["llama", "gpt"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_port_artifact_serves_through_jax(models, tmp_path, arch, sampled):
    jm, tm = models[arch]
    vocab = tm.config.vocab_size
    kw = dict(GEO, **(SAMPLED if sampled else {}))
    path = save_lm(tm, str(tmp_path / "lm"))
    assert path.endswith(".pdmodel") and os.path.exists(path)
    want = _serve(Engine(tm, **kw), vocab, sampled)
    jpred = jinf.create_llm_predictor(jinf.Config(path), **kw)
    assert _serve(jpred.engine, vocab, sampled) == want
    pred = inference.create_llm_predictor(path, device="cpu", **kw)
    assert _serve(pred.engine, vocab, sampled) == want
    cfgs = jit.load(path).configs
    assert cfgs["llm_arch"] == arch
    assert cfgs["llm_config"] == dataclasses.asdict(jm.config)


def test_bf16_round_trip_is_bit_identical(tmp_path):
    """A bf16 Llama through ``jit.save``/``load`` and ``save_lm`` ->
    ``create_llm_predictor``: every tensor in its dtype, bit for bit, and
    the predictor serves the source engine's tokens."""
    torch.manual_seed(0)
    m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                             num_hidden_layers=1),
                         device="cpu").eval()
    sd = m.state_dict()
    assert sd["lm_head.weight"].dtype == torch.bfloat16
    path = save_lm(m, str(tmp_path / "bf16"))
    got = jit.load(path).state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert all(a.dtype == np.float32 for a in raw["state_dict"].values())
    pred = inference.create_llm_predictor(path, device="cpu", **GEO)
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert _serve(pred.engine, 1024, False) == _serve(Engine(m, **GEO), 1024,
                                                      False)


def test_jax_bf16_artifact_needs_ml_dtypes(tmp_path, monkeypatch):
    """A bf16 JAX artifact holds ml_dtypes arrays: they load exactly where
    ml_dtypes imports, and name it where it does not."""
    paddle.seed(0)
    jl = jnn.Linear(8, 4)
    jl.to(dtype="bfloat16")
    path = str(tmp_path / "jbf16")
    jjit.save(jl, path)
    sd = jit.load(path).state_dict()
    want = {k: np.asarray(v._data).astype(np.float32)
            for k, v in jl.state_dict().items()}
    for k, v in sd.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), want[k])
    monkeypatch.setitem(__import__("sys").modules, "ml_dtypes", None)
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        jit.load(path)


# ---------------------------------------------------------------------------
# the Predictor / _Handle surface (tests/test_inference_predictor.py)
# ---------------------------------------------------------------------------

class _TwoOut(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 3)

    def forward(self, ids, mask):
        h = self.fc(ids) * mask
        return h, h.sum(axis=-1)


def test_predictor_on_a_jax_graph_artifact(tmp_path):
    """A JAX artifact with StableHLO: the port's predictor has the JAX
    predictor's names, its weights are the JAX layer's, and running it
    raises, naming the port queue item."""
    paddle.seed(0)
    layer = _TwoOut()
    layer.eval()
    path = str(tmp_path / "m")
    jjit.save(layer, path, input_spec=[
        InputSpec([None, 4], "float32", name="ids"),
        InputSpec([None, 3], "float32", name="mask")])
    jpred = jinf.create_predictor(jinf.Config(path))
    pred = inference.create_predictor(inference.Config(path))
    assert pred.get_input_names() == jpred.get_input_names() == ["ids",
                                                                   "mask"]
    assert pred.get_output_names() == jpred.get_output_names()
    tl = jit.load(path)
    assert tl.has_graph
    for k, v in layer.state_dict().items():
        np.testing.assert_array_equal(tl.state_dict()[k].numpy(),
                                      np.asarray(v._data))
    ids = np.ones((2, 4), np.float32)
    pred.get_input_handle("ids").copy_from_cpu(ids)
    with pytest.raises(RuntimeError, match="not filled"):
        pred.run()
    pred.get_input_handle("mask").copy_from_cpu(np.ones((2, 3), np.float32))
    with pytest.raises(NotImplementedError, match="item 9"):
        pred.run()
    with pytest.raises(NotImplementedError, match="item 9"):
        pred.run([ids, np.ones((2, 3), np.float32)])
    pool = inference.PredictorPool(inference.Config(path), size=2)
    assert pool.retrive(1)._layer is pool.retrieve(0)._layer
    with pytest.raises(ValueError):
        inference.PredictorPool(inference.Config(path), size=0)


def _handle_story(Tensor):
    """The JAX test's handle sequence; what each step gave."""
    out = []
    h = Tensor("x", shape=(3, 6))
    out.append(h.shape())
    h.copy_from_cpu(np.arange(18, dtype=np.float32))   # to the declared
    out.append(h.copy_to_cpu().shape)
    for bad in (lambda: h.copy_from_cpu(np.zeros((4, 4), np.float32)),
                lambda: h.reshape([5, 6])):
        try:
            bad()
            out.append("no error")
        except ValueError:
            out.append("ValueError")
    out.append(h.shape())
    h.reshape([6, 3])
    out.append(h.shape())
    h2 = Tensor("fresh", shape=(2, 2))
    h2.reshape([7, 3])
    out.append(h2.shape())
    return out


def test_handle_surface_matches_jax():
    assert _handle_story(inference.Tensor) == _handle_story(jinf.Tensor)
    assert _handle_story(inference.Tensor)[2:4] == ["ValueError",
                                                    "ValueError"]


def test_type_surface_matches_jax():
    for name in ("DataType", "PlaceType", "PrecisionType", "BackendType"):
        assert {e.name: e.value for e in getattr(inference, name)} == \
            {e.name: e.value for e in getattr(jinf, name)}
    for dt in inference.DataType:
        assert inference.get_num_bytes_of_data_type(dt) == \
            jinf.get_num_bytes_of_data_type(jinf.DataType[dt.name])
    assert inference.get_trt_compile_version() == (0, 0, 0)
    assert inference.get_trt_runtime_version() == (0, 0, 0)
    assert isinstance(inference.get_version(), str)
    c = inference.Config()
    c.set_prog_file("x")
    c.switch_ir_optim(False)
    assert c.prog_file() == "x" and c.summary() == jinf.Config(
        "x").summary() | {"ir_optim": False}
    with pytest.raises(NotImplementedError):
        inference.convert_to_mixed_precision("a", "b", "c", "d", "bf16",
                                             "gpu")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals(models, tmp_path, monkeypatch):
    _, tm = models["llama"]
    with pytest.raises(NotImplementedError, match="item 9"):
        jit.save(tm, str(tmp_path / "g"), input_spec=[object()])
    assert not os.path.exists(tmp_path / "g.pdmodel")
    with pytest.raises(NotImplementedError, match="runtime services"):
        save_lm(tm, str(tmp_path / "aot"), precompile=True)
    monkeypatch.setenv("PADDLE_TPU_AOT_PRECOMPILE", "1")
    with pytest.raises(NotImplementedError, match="runtime services"):
        save_lm(tm, str(tmp_path / "aot"))
    monkeypatch.delenv("PADDLE_TPU_AOT_PRECOMPILE")
    assert not os.path.exists(tmp_path / "aot.pdmodel")
    with pytest.raises(TypeError):
        save_lm(torch.nn.Linear(2, 2), str(tmp_path / "lin"))
    # a graph-less artifact: JAX's RuntimeError, in both packages
    path = jit.save(torch.nn.Linear(2, 2), str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="no compiled graph"):
        jit.load(path)(np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="no compiled graph"):
        jjit.load(str(tmp_path / "w"))(np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="save_lm"):
        inference.create_llm_predictor(path, device="cpu")
    # an artifact recording an AOT geometry (JAX's precompiled save_lm)
    geo = jit.save(tm, str(tmp_path / "geo"), llm_arch="llama",
                   llm_config=dataclasses.asdict(tm.config),
                   aot_geometry=dict(n_slots=2))
    with pytest.raises(NotImplementedError, match="runtime services"):
        inference.create_llm_predictor(geo, device="cpu")
    # a pickle naming any other global is refused, never called
    evil = str(tmp_path / "evil.pdmodel")

    class Boom:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    with open(evil, "wb") as f:
        pickle.dump({"format": "paddle_tpu.jit", "x": Boom()}, f)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        jit.load(evil)


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def test_planted_fault_bf16_record_dropped(tmp_path, monkeypatch):
    """Without ``state_dtypes`` the round trip gives float32 back."""
    m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                             num_hidden_layers=1),
                         device="cpu")
    orig = tser.TranslatedLayer.__init__

    def forgetful(self, payload):
        payload.pop("state_dtypes", None)
        orig(self, payload)

    monkeypatch.setattr(tser.TranslatedLayer, "__init__", forgetful)
    got = jit.load(jit.save(m, str(tmp_path / "m"))).state_dict()
    assert any(got[k].dtype != v.dtype for k, v in m.state_dict().items())


def test_planted_fault_swapped_layers(models, tmp_path):
    """Two layers' weights swapped in a JAX artifact: the port predictor's
    tokens leave the JAX source engine's."""
    jm, tm = models["llama"]
    path = jsrv.save_lm(jm, str(tmp_path / "lm"))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    sd = payload["state_dict"]
    for name in [k for k in sd if k.startswith("llama.layers.0.")]:
        other = name.replace("layers.0.", "layers.1.")
        sd[name], sd[other] = sd[other], sd[name]
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    want = _serve(jsrv.Engine(jm, **GEO), 1024, False)
    pred = inference.create_llm_predictor(path, device="cpu", **GEO)
    assert _serve(pred.engine, 1024, False) != want
