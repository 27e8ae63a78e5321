"""The port's CNN path against the JAX package's, on the CPU: batch norm,
pooling, channels-last convolution and layout, LeNet and ResNet, and the
train step's buffers.

- ``F.batch_norm`` in training and eval mode, fp32 (``FWD_TOL``, 1e-5),
  bf16 and O2's bf16 weight over fp32 buffers (2e-2), NCHW and NHWC; the running statistics after three
  training calls within 1e-6 (fp32);
- every pooling function over padding forms, ``exclusive``, channels-
  last and odd adaptive sizes: exact for max, 1e-6 for avg. ``ceil_mode``
  is held to JAX where it does not change the output's length (JAX
  ignores it) and to a numpy rendering of paddle's rule where it does;
- ``Conv2D(data_format="NHWC")`` within ``FWD_TOL``;
- ``to_channels_last`` and ``fold_conv_bn`` on ResNet-18 against JAX's
  (``FWD_TOL``, 1e-4 for the folded model);
- LeNet, and ResNet-18 (10 classes, [4, 3, 32, 32]) forward in training
  and eval mode (1e-4, and atol 1e-4 in training, where batch norm over
  4 images amplifies round-off), and three fleet + Momentum(0.001, 0.9)
  steps at batch 16: losses within ``STEP_RTOL`` (1e-4 relative), every
  parameter and batch-norm buffer within ``STEP_RTOL`` of its array's
  largest magnitude, against JAX's train step;
- ResNet-50's and ResNeXt-50's ``state_dict`` keys, shapes and
  parameter counts equal JAX's, and one eval forward at [2, 3, 32, 32]
  (1e-4, atol 1e-5 of the logits' scale); each of the thirteen factories
  asks for JAX's block, depth, width and groups;
- a model with batch norm is refused at a data degree above 1;
- ``TrainStep.state_dict`` carries the buffers: a supervised step that
  is skipped for a non-finite loss leaves the running statistics bit for
  bit as the guard had them, a checkpoint resume restores them, and the
  JAX package's ``CheckpointManager`` reads the port's step.
"""
import copy
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import torch_parity as P
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.framework import layout as jlayout
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as jmodels
from paddle_tpu import optimizer as jax_optim

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn, optimizer, resilience as res
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.fleet.placement import place_model
from paddle_tpu_torch.framework import layout
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models

STEP_RTOL = 1e-4
LR, MOMENTUM = 0.001, 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_model(make_jax, port_model):
    """A JAX model holding ``port_model``'s parameters AND buffers."""
    with P.constant_init():
        jm = make_jax()
    src = {k: v.detach().float().numpy()
           for k, v in port_model.state_dict().items()}
    own = jm.state_dict()
    assert own.keys() == src.keys()
    for k, t in own.items():
        t._data = jnp.asarray(src[k], dtype=t._data.dtype)
    return jm


# -- batch norm -------------------------------------------------------------

def _jax_bn(x, rm, rv, w, b, training, data_format, calls=1):
    """(out, running mean, running var) of ``calls`` JAX batch norms."""
    def f(x, rm, rv, w, b):
        out = None
        for _ in range(calls):
            out = JF.batch_norm(x, rm, rv, w, b, training=training,
                                data_format=data_format)
        return out, rm, rv
    return P.jax_call(f, x, rm, rv, w, b)


# x, weight and bias; the buffers ("o2": what amp.decorate leaves, a bf16
# weight and bias over fp32 buffers, which torch's op refuses)
BN_DTYPES = {"float32": ("float32", "float32"),
             "bfloat16": ("bfloat16", "bfloat16"),
             "o2": ("bfloat16", "float32")}


@pytest.mark.parametrize("dtype", list(BN_DTYPES))
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(dtype, data_format, training):
    rng = _rng(0)
    shape = (4, 6, 5, 3) if data_format == "NCHW" else (4, 5, 3, 6)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    rm = rng.standard_normal(6).astype(np.float32)
    rv = rng.uniform(0.5, 2, 6).astype(np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    xdt, bdt = BN_DTYPES[dtype]
    arrays = [jnp.asarray(a, getattr(jnp, d)) for a, d in
              ((x, xdt), (rm, bdt), (rv, bdt), (w, xdt), (b, xdt))]
    want = _jax_bn(*arrays, training, data_format)
    t = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, str(a.dtype))) for a in arrays]
    got = F.batch_norm(t[0], t[1], t[2], t[3], t[4], training=training,
                       data_format=data_format)
    assert got.dtype == getattr(torch, xdt)
    assert t[1].dtype == t[2].dtype == getattr(torch, bdt)
    tol = P.FWD_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for g, w_ in zip((got, t[1], t[2]), want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w_, np.float32), **tol)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_running_statistics_after_three_calls(data_format):
    """Paddle's momentum (0.9 on the old value), the unbiased running
    variance: within 1e-6 of JAX's after three training calls."""
    rng = _rng(1)
    x = (rng.standard_normal((8, 4, 3, 3)) * 3 + 1).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    rm, rv = np.zeros(4, np.float32), np.ones(4, np.float32)
    _, jm, jv = _jax_bn(x, rm, rv, None, None, True, data_format, calls=3)
    bn = nn.BatchNorm2D(4, data_format=data_format, device="cpu")
    for _ in range(3):
        bn(torch.from_numpy(x))
    np.testing.assert_allclose(bn._mean.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn._variance.numpy(), jv, rtol=1e-6,
                               atol=1e-6)
    assert set(bn.state_dict()) == {"weight", "bias", "_mean", "_variance"}


def test_batch_norm_layer_options_match_jax():
    """``weight_attr``/``bias_attr=False`` drop the affine parameters,
    ``use_global_stats`` reads the running statistics in training, and a
    bf16 layer keeps bf16 buffers through training."""
    bn = nn.BatchNorm2D(3, weight_attr=False, bias_attr=False, device="cpu")
    assert list(bn.state_dict()) == ["_mean", "_variance"]
    x = torch.from_numpy(_rng(2).standard_normal((2, 3, 4, 4)).astype(
        np.float32))
    g = nn.BatchNorm2D(3, use_global_stats=True, device="cpu")
    np.testing.assert_allclose(g(x).detach().numpy(),
                               (x / math.sqrt(1 + 1e-5)).numpy(), rtol=1e-6)
    assert torch.equal(g._mean, torch.zeros(3))
    h = nn.BatchNorm2D(3, device="cpu").to(torch.bfloat16)
    h(x.bfloat16())
    assert h._mean.dtype == h._variance.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="SyncBatchNorm"):
        nn.SyncBatchNorm(3)


# -- pooling ----------------------------------------------------------------

# name: (function, shape, keyword arguments)
POOL_CASES = {
    "max2d k3 s2 p1": ("max_pool2d", (2, 3, 9, 9),
                       dict(kernel_size=3, stride=2, padding=1)),
    "max2d k2": ("max_pool2d", (2, 3, 8, 7), dict(kernel_size=2)),
    "max2d per side": ("max_pool2d", (2, 3, 8, 7),
                       dict(kernel_size=3, stride=2, padding=[0, 1, 2, 0])),
    "max2d pairs": ("max_pool2d", (2, 3, 8, 7),
                    dict(kernel_size=(3, 2), stride=(2, 1),
                         padding=[[1, 0], [0, 1]])),
    "max2d SAME": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d NHWC": ("max_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "max2d ceil, same length": ("max_pool2d", (2, 3, 8, 8),
                                dict(kernel_size=2, stride=2,
                                     ceil_mode=True)),
    "avg2d exclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1)),
    "avg2d inclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False)),
    "avg2d per side": ("avg_pool2d", (2, 3, 8, 7),
                       dict(kernel_size=3, stride=2, padding=[1, 0, 2, 1])),
    "avg2d SAME": ("avg_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d VALID": ("avg_pool2d", (2, 3, 9, 8),
                    dict(kernel_size=3, stride=2, padding="VALID")),
    "avg2d NHWC": ("avg_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1)),
    "max1d NLC": ("max_pool1d", (2, 11, 3),
                  dict(kernel_size=3, stride=2, padding=1,
                       data_format="NLC")),
    "avg1d": ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1)),
    "avg1d inclusive": ("avg_pool1d", (2, 3, 11),
                        dict(kernel_size=4, stride=3, padding=2,
                             exclusive=False)),
    "max3d": ("max_pool3d", (2, 3, 5, 6, 7), dict(kernel_size=2, stride=2,
                                                  padding=1)),
    "avg3d": ("avg_pool3d", (2, 3, 5, 6, 7), dict(kernel_size=3, stride=2,
                                                  padding=1)),
    "avg3d NDHWC": ("avg_pool3d", (2, 5, 6, 7, 3),
                    dict(kernel_size=2, stride=1, data_format="NDHWC")),
    "adaptive avg2d 1x1": ("adaptive_avg_pool2d", (2, 3, 7, 7),
                           dict(output_size=1)),
    "adaptive avg2d odd": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                           dict(output_size=(3, 5))),
    "adaptive avg2d even": ("adaptive_avg_pool2d", (2, 3, 8, 9),
                            dict(output_size=(4, 3))),
    "adaptive avg2d None": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                            dict(output_size=(None, 2))),
    "adaptive avg2d NHWC": ("adaptive_avg_pool2d", (2, 7, 9, 3),
                            dict(output_size=(3, 2), data_format="NHWC")),
    "adaptive max2d odd": ("adaptive_max_pool2d", (2, 3, 7, 7),
                           dict(output_size=3)),
    "adaptive avg1d": ("adaptive_avg_pool1d", (2, 3, 7),
                       dict(output_size=5)),
    "adaptive max1d": ("adaptive_max_pool1d", (2, 3, 10),
                       dict(output_size=4)),
    "adaptive avg3d": ("adaptive_avg_pool3d", (2, 3, 5, 6, 7),
                       dict(output_size=(2, 3, 3))),
    "adaptive max3d": ("adaptive_max_pool3d", (2, 3, 5, 6, 7),
                       dict(output_size=(2, 3, 1))),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_jax(case):
    fname, shape, kw = POOL_CASES[case]
    x = _rng(3).standard_normal(shape).astype(np.float32)
    want = P.jax_call(lambda a: getattr(JF, fname)(a, **kw), x)
    got = getattr(F, fname)(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    if "max" in fname:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _paddle_pool_2d(x, k, s, p, kind, exclusive=True):
    """Paddle's ceil-mode pooling, element by element (numpy)."""
    n, c, h, w = x.shape
    oh = math.ceil((h + 2 * p - k) / s) + 1
    ow = math.ceil((w + 2 * p - k) / s) + 1
    out = np.zeros((n, c, oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            h0, w0 = i * s - p, j * s - p
            hs, ws = max(h0, 0), max(w0, 0)
            he, we = min(h0 + k, h), min(w0 + k, w)
            win = x[:, :, hs:he, ws:we]
            if kind == "max":
                out[:, :, i, j] = win.max(axis=(2, 3))
            else:
                div = (he - hs) * (we - ws) if exclusive else k * k
                out[:, :, i, j] = win.sum(axis=(2, 3)) / div
    return out


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_ceil_mode_is_paddles(kind):
    """Where ``ceil_mode`` lengthens the output (7 rows -> 4 windows of 2
    at stride 2; 8 columns -> 5 windows of 3 at stride 2 with padding 1)
    the port
    follows paddle's rule; the JAX package ignores ``ceil_mode`` and gives
    the floor length (ROADMAP.md, Queue 3)."""
    x = _rng(4).standard_normal((2, 3, 7, 8)).astype(np.float32)
    for k, s, p in ((2, 2, 0), (3, 2, 1)):
        fn = F.max_pool2d if kind == "max" else F.avg_pool2d
        got = fn(torch.from_numpy(x), k, s, p, ceil_mode=True).numpy()
        want = _paddle_pool_2d(x, k, s, p, kind)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        jfn = JF.max_pool2d if kind == "max" else JF.avg_pool2d
        floor = P.jax_call(lambda a: jfn(a, k, s, p, ceil_mode=True), x)
        assert floor.shape != got.shape


def test_pool_layers_and_queued_options():
    x = torch.from_numpy(_rng(5).standard_normal((2, 3, 8, 8)).astype(
        np.float32))
    layer = nn.MaxPool2D(3, 2, 1)
    assert torch.equal(layer(x), F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(nn.AdaptiveAvgPool2D(1)(x),
                       F.adaptive_avg_pool2d(x, 1))
    out, mask = F.max_pool2d(x, 2, return_mask=True)
    assert torch.equal(out, F.max_pool2d(x, 2))
    assert torch.equal(out.flatten(2), x.flatten(2).gather(
        2, mask.flatten(2).long()))
    with pytest.raises(NotImplementedError, match="item 9"):
        nn.AvgPool2D(2, divisor_override=3)(x)


# -- channels-last conv -----------------------------------------------------

@pytest.mark.parametrize("case", [
    (4, 8, 3, 2, 1, 1), (4, 6, 3, 1, [[0, 0], [1, 0], [2, 1], [0, 0]], 2),
    (4, 8, 4, 2, "SAME", 1), (4, 4, 3, 1, 1, 4)],
    ids=["3x3 s2 p1", "nested NHWC", "SAME s2", "depthwise"])
def test_nhwc_conv2d_matches_jax(case):
    cin, cout, k, s, p, g = case
    tc = nn.Conv2D(cin, cout, k, stride=s, padding=p, groups=g,
                   data_format="NHWC", device="cpu")
    w, b = tc.weight.detach().numpy(), tc.bias.detach().numpy()
    x = _rng(6).standard_normal((2, 11, 13, cin)).astype(np.float32)
    want = P.jax_call(lambda a: JF.conv2d(
        a, JTensor(w), JTensor(b), stride=s, padding=p, groups=g,
        data_format="NHWC"), x)
    with torch.no_grad():
        got = tc(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)


# -- models -----------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet18s():
    """(JAX ResNet-18 holding the port's weights, the port's: seed 0, 10
    classes)."""
    pt.seed(0)
    tm = models.resnet18(num_classes=10, device="cpu")
    return _jax_model(lambda: jmodels.resnet18(num_classes=10), tm), tm


@pytest.fixture(scope="module")
def images():
    return _rng(7).standard_normal((4, 3, 32, 32)).astype(np.float32)


def _forward_pair(jm, tm, x, training):
    """(port output, JAX output) in one mode. A JAX batch norm in training
    writes its buffers inside the trace: they are put back after."""
    jm.train() if training else jm.eval()
    tm.train(training)
    held = {k: t._data for k, t in jm.state_dict().items()}
    try:
        want = P.jax_call(jm, x)
    finally:
        for k, t in jm.state_dict().items():
            t._data = held[k]
        jm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    tm.train()
    return got.numpy(), want


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_resnet18_forward_matches_jax(resnet18s, images, training):
    jm, tm = resnet18s
    tm = copy.deepcopy(tm)              # training mode moves the buffers
    got, want = _forward_pair(jm, tm, images, training)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_lenet_forward_matches_jax(training):
    pt.seed(1)
    tm = models.LeNet(device="cpu")
    jm = _jax_model(jmodels.LeNet, tm)
    x = _rng(8).standard_normal((3, 1, 28, 28)).astype(np.float32)
    got, want = _forward_pair(jm, tm, x, training)
    np.testing.assert_allclose(got, want, **P.FWD_TOL)


def test_to_channels_last_matches_jax(resnet18s, images):
    jm, tm = resnet18s
    for training in (True, False):
        # a fresh JAX wrapper for each mode: after a training-mode call
        # under jax.jit, JAX's own wrapper's eval output moves away from
        # its NCHW model's (by up to 12 here), which a fresh one does not
        jcl = jlayout.to_channels_last(copy.deepcopy(jm))
        tcl = layout.to_channels_last(copy.deepcopy(tm))
        assert len(tcl.plan.converted) == len(jcl.plan.converted)
        assert set(tcl.state_dict()) == set(jcl.state_dict())
        got, want = _forward_pair(jcl, tcl, images, training)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="channels-last-safe"):
        layout.to_channels_last(models.LeNet(device="cpu"))


def test_fold_conv_bn_matches_jax(resnet18s, images):
    jm, tm = resnet18s
    jf, tf = copy.deepcopy(jm), copy.deepcopy(tm)
    jf.eval()
    tf.eval()
    assert layout.fold_conv_bn(tf) == jlayout.fold_conv_bn(jf)
    assert set(tf.state_dict()) == set(jf.state_dict())
    got, want = _forward_pair(jf, tf, images, False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    unfolded, _ = _forward_pair(jm, tm, images, False)
    np.testing.assert_allclose(got, unfolded, rtol=1e-4, atol=1e-4)


def _jax_momentum_train(model, x, y, steps=3):
    jax_mesh.set_mesh(None)
    try:
        s = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=s)
        model = jax_fleet.distributed_model(model)
        opt = jax_fleet.distributed_optimizer(jax_optim.Momentum(
            learning_rate=LR, momentum=MOMENTUM,
            parameters=model.parameters()), strategy=s)
        step = opt.make_train_step(model, lambda m, a, b: JF.cross_entropy(
            m(a).astype("float32"), b))
        xs = [jpaddle.to_tensor(x), jpaddle.to_tensor(y)]
        losses = [float(step(*xs).numpy()) for _ in range(steps)]
        return losses, P.arrays(model)
    finally:
        jax_mesh.set_mesh(None)


def _port_momentum_train(model, x, y, steps=3):
    s = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.Momentum(
        learning_rate=LR, momentum=MOMENTUM, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, a, b: F.cross_entropy(
        m(a).float(), b))
    xs = (torch.from_numpy(x), torch.from_numpy(y))
    return [float(step(*xs)) for _ in range(steps)], P.arrays(model)


def test_resnet18_three_momentum_steps_match_jax(resnet18s):
    """At [16, 3, 32, 32] and lr 0.001: at [4, 3, 32, 32] the last stage's
    batch norms see 4 values a channel and three steps of the port in
    fp32 and in fp64 already differ by 10% of a bias, so no fp32
    comparison holds there. At lr 0.01 the loss falls to 0.04 by the
    third step and what is left of the gradients is near round-off: JAX
    and the port then differ by up to 0.75% of a bias (2.6e-5)."""
    jm, tm = resnet18s
    x = _rng(7).standard_normal((16, 3, 32, 32)).astype(np.float32)
    y = _rng(9).integers(0, 10, (16,)).astype(np.int64)
    want_losses, want = _jax_momentum_train(copy.deepcopy(jm), x, y)
    losses, got = _port_momentum_train(copy.deepcopy(tm), x, y)
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_RTOL)
    assert losses[2] < losses[0]
    assert got.keys() == want.keys()
    assert any(k.endswith("_mean") for k in got)
    worst = max(np.abs(got[k] - w).max() / np.abs(w).max()
                for k, w in want.items())
    assert worst <= STEP_RTOL, worst


@pytest.mark.parametrize("factory", ["resnet50", "resnext50_32x4d"])
def test_deep_resnet_state_dicts_match_jax(factory):
    pt.seed(2)
    tm = getattr(models, factory)(device="cpu")
    with P.constant_init():
        jm = getattr(jmodels, factory)()
    want = {k: tuple(v._data.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(p._data.shape)) for p in jm.parameters())
    if factory == "resnet50":
        assert n == 25_557_032
    jm = _jax_model(getattr(jmodels, factory), tm)
    x = _rng(10).standard_normal((2, 3, 32, 32)).astype(np.float32)
    got, want = _forward_pair(jm, tm, x, False)
    assert got.shape == (2, 1000)
    # 16 blocks on running statistics of 0 and 1 grow the logits to ~1e2
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("factory", sorted(set(models.resnet.__all__)
                                           - {"BasicBlock",
                                              "BottleneckBlock", "ResNet"}))
def test_every_factory_builds_what_jaxs_builds(factory, monkeypatch):
    """Each of the thirteen factories asks for JAX's block, depth, width
    and groups (caught before anything is built)."""
    from paddle_tpu.vision.models import resnet as jresnet
    from paddle_tpu_torch.vision.models import resnet as tresnet

    def catch(block, depth, pretrained=False, **kw):
        return block.__name__, depth, kw.get("width", 64), \
            kw.get("groups", 1)
    monkeypatch.setattr(jresnet, "_resnet", catch)
    monkeypatch.setattr(tresnet, "_resnet", catch)
    assert getattr(tresnet, factory)() == getattr(jresnet, factory)()


def test_batch_norm_is_refused_above_data_degree_one():
    model = models.resnet18(num_classes=10, device="cpu")
    for degrees in ({"dp": 2}, {"sharding": 2}):
        m = mesh.build_mesh(world_size=2, rank=0, **degrees)
        with pytest.raises(NotImplementedError, match="batch norm"):
            place_model(model, m, 0)
    # tp without data parallelism is not the refusal's business
    m = mesh.build_mesh(world_size=1, rank=0)
    place_model(nn.Sequential(nn.Linear(2, 2, device="cpu")), m, 0)


# -- the train step's buffers -----------------------------------------------

def _bn_step():
    pt.seed(3)
    net = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                        nn.BatchNorm2D(4, device="cpu"), nn.ReLU(),
                        nn.Flatten(), nn.Linear(4 * 6 * 6, 3, device="cpu"))
    mesh.set_mesh(None)
    step = fleet.make_train_step(
        net, optimizer.Momentum(LR, MOMENTUM, parameters=net.parameters()),
        lambda m, a, b: F.cross_entropy(m(a), b))
    rng = _rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 3, 6, 6)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (4,)).astype(np.int64))
    return net, step, x, y


def test_train_step_state_dict_carries_buffers():
    net, step, x, y = _bn_step()
    sd = step.state_dict()
    assert set(sd["buffers"]) == {"1._mean", "1._variance"}
    step(x, y)
    snap = {k: {n: t.clone() for n, t in v.items()}
            if k in ("params", "buffers", "scaler") else
            {n: {m: t.clone() for m, t in s.items()} for n, s in v.items()}
            for k, v in step.state_dict().items()}
    step(x, y)
    assert not torch.equal(net[1]._mean, snap["buffers"]["1._mean"])
    step.load_state_dict(snap)
    for k in ("1._mean", "1._variance"):
        assert torch.equal(net.state_dict()[k], snap["buffers"][k])


def test_supervisor_skip_restores_batch_norm_statistics():
    """A step whose batch is non-finite writes NaN into the running
    statistics before its loss shows it; the supervisor skips it and
    restores its guard, which must hold the statistics (bit for bit)."""
    net, step, x, y = _bn_step()
    sup = res.Supervisor(step, res.TrainState(train_step=step),
                         nan_patience=3)
    assert sup.step(x, y) is not None
    before = {k: v.clone() for k, v in net.state_dict().items()}
    bad = x.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert sup.step(bad, y) is None
    assert sup.stats()["skipped"] == 1
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.isfinite(net[1]._mean).all()


def test_checkpoint_resume_restores_buffers_and_jax_reads_it(tmp_path):
    net, step, x, y = _bn_step()
    step(x, y)
    state = res.TrainState(train_step=step)
    CheckpointManager(tmp_path, device="cpu").save(0, state.capture(),
                                                   async_save=False)
    want = {k: v.clone() for k, v in net.state_dict().items()}
    step(x, y)
    _, snap = CheckpointManager(tmp_path, device="cpu").restore_latest(
        state.capture())
    state.restore(snap)
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    _, got = jck.CheckpointManager(str(tmp_path)).restore_latest()
    for k in ("1._mean", "1._variance"):
        np.testing.assert_array_equal(
            np.asarray(got["train_step"]["buffers"][k]), want[k].numpy())
