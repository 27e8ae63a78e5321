"""The port's ``nn`` layers against the JAX package's: the layer rows of
``chip_smoke.nn_cases`` (padding, resizing, ``Bilinear``,
``Fold``/``Unfold``, the shuffles, the dropouts, the group, instance and
local-response norms, ``Conv1D``/``Conv3D``, ``Conv2D``'s padding modes
and the transposed convolutions; the activation layers are in
``test_torch_nn_activations.py``) at ``NN_ROWS_CPU`` size: each layer
built from seed 0, its state dict (keys equal to JAX's) copied into the
JAX layer, outputs within the row's ``OP_TOL`` class and the gradients of
the input and every parameter within ``GRAD_TOL``. Beside the table:
every class in ``paddle_tpu_torch/nn/layer`` is an ``nn.Layer``,
``Linear`` takes ``ParamAttr``s and ``set_state_dict``,
``Embedding(padding_idx=)`` zeroes its row and passes it no gradient,
``LayerDict``/``ParameterList`` keep JAX's keys, and ``clip_grad_norm_``
/ ``clip_grad_value_`` clip as JAX's do.
"""
import inspect

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import layer as pt_layer

from torch_nn_parity import cases, run_row, state_arrays

CASES = cases("layers")


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_layer_matches_jax(case):
    err = run_row(case)
    assert err is None, err


def test_every_layer_class_is_an_nn_layer():
    classes = [c for mod in (pt_layer.activation, pt_layer.common,
                             pt_layer.container, pt_layer.conv,
                             pt_layer.loss, pt_layer.norm, pt_layer.pooling,
                             pt_layer.rnn, pt_layer.transformer)
               for _, c in inspect.getmembers(mod, inspect.isclass)
               if c.__module__ == mod.__name__]
    assert len(classes) >= 100
    assert all(issubclass(c, pt.nn.Layer) for c in classes), [
        c for c in classes if not issubclass(c, pt.nn.Layer)]


def test_linear_takes_param_attrs_and_state_dicts():
    init = pt.nn.initializer.Constant(0.5)
    lin = pt.nn.Linear(3, 4, weight_attr=pt.ParamAttr(
        initializer=init, learning_rate=0.1),
        bias_attr=pt.ParamAttr(trainable=False))
    jlin = paddle.nn.Linear(3, 4, weight_attr=paddle.ParamAttr(
        initializer=paddle.nn.initializer.Constant(0.5)))
    assert torch.all(lin.weight == 0.5)
    assert lin.weight.optimize_attr["learning_rate"] == 0.1
    assert not lin.bias.requires_grad
    assert pt.nn.Linear(3, 4, bias_attr=False).bias is None
    sd = {"weight": np.arange(12, dtype=np.float32).reshape(3, 4),
          "bias": np.ones(4, np.float32)}
    assert lin.set_state_dict(sd) == tuple(jlin.set_state_dict(sd))
    np.testing.assert_array_equal(state_arrays(lin)["weight"],
                                  state_arrays(jlin)["weight"])


def test_embedding_padding_row_is_zero_and_gets_no_gradient():
    pt.seed(0)
    emb = pt.nn.Embedding(6, 3, padding_idx=2, device="cpu")
    assert torch.all(emb.weight[2] == 0)
    jemb = paddle.nn.Embedding(6, 3, padding_idx=2)
    jemb.set_state_dict(state_arrays(emb))
    ids = np.array([[2, 0, 2], [5, 2, 1]], np.int64)
    out = emb(torch.from_numpy(ids))
    jout = jemb(paddle.to_tensor(ids))
    np.testing.assert_array_equal(out.detach().numpy(), jout.numpy())
    out.sum().backward()
    paddle.sum(jout).backward()
    assert torch.all(emb.weight.grad[2] == 0)
    np.testing.assert_array_equal(emb.weight.grad.numpy(),
                                  jemb.weight.grad.numpy())
    assert list(emb.state_dict()) == list(jemb.state_dict())


def test_containers_keep_jax_keys():
    pt.seed(1)
    d = pt.nn.LayerDict({"a": pt.nn.Linear(2, 3), "b": pt.nn.Conv1D(2, 2, 1)})
    jd = paddle.nn.LayerDict({"a": paddle.nn.Linear(2, 3),
                              "b": paddle.nn.Conv1D(2, 2, 1)})
    assert list(d.state_dict()) == list(jd.state_dict())
    assert list(d.keys()) == list(jd.keys()) and len(d) == 2
    d["c"] = pt.nn.ReLU()
    assert "c" in d and isinstance(d.pop("c"), pt.nn.ReLU)
    ps = pt.nn.ParameterList([torch.nn.Parameter(torch.ones(2)),
                              torch.nn.Parameter(torch.zeros(3))])
    jps = paddle.nn.ParameterList([
        paddle.create_parameter([2], "float32"),
        paddle.create_parameter([3], "float32")])
    assert list(ps.state_dict()) == list(jps.state_dict())
    assert len(ps) == 2 and ps[1].shape == (3,)
    ll = pt.nn.LayerList([pt.nn.ReLU(), pt.nn.Tanh()])
    assert isinstance(ll[0:1], pt.nn.LayerList) and len(ll) == 2


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 3), (5,))]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    jps = [paddle.create_parameter(list(g.shape), "float32") for g in grads]
    for p, jp, g in zip(ps, jps, grads):
        p.grad = torch.from_numpy(g.copy())
        jp.grad = paddle.to_tensor(g)
    total = pt.nn.clip_grad_norm_(ps, 2.0, norm_type)
    jtotal = paddle.nn.clip_grad_norm_(jps, 2.0, norm_type)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for p, jp in zip(ps, jps):
        np.testing.assert_allclose(p.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)
    pt.nn.clip_grad_value_(ps, 0.1)
    paddle.nn.clip_grad_value_(jps, 0.1)
    for p, jp in zip(ps, jps):
        np.testing.assert_array_equal(p.grad.numpy(), jp.grad.numpy())


def test_submodule_aliases():
    assert pt.nn.loss.CrossEntropyLoss is pt.nn.CrossEntropyLoss
    assert pt.nn.decode.dynamic_decode is pt.nn.dynamic_decode
    assert hasattr(pt.nn.quant, "Int8Linear")
