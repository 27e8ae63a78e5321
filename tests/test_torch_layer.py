"""``nn.Layer`` and ``ParamAttr`` in the port against the JAX package's,
and the slice as a whole: one user-written decoder layer
(``chip_smoke.user_decoder_layer``: hidden 64, 4 heads, FFN 176, 16
tokens, written once on paddle's eager surface) built with ``paddle``
bound to each package in turn. Weights cross through numpy (the state
dict keys are equal); the forward, the ``loss.backward()`` gradients and
3 steps of each package's ``optimizer.Adam`` with ``clear_grad()`` agree
within 1e-5 relative. The Layer's walkers, state dict, hooks, dtype
moves and ``ParamAttr`` follow the JAX package's, and the walkers take the
port's own modules (``nn.Linear``) as children.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework.io import load_numpy_state_dict

HIDDEN, HEADS, FFN, TOKENS = 64, 4, 176, 16
RTOL = 1e-5


@pytest.fixture(autouse=True)
def on_the_cpu():
    with cs.using_device("cpu"):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _arrays(layer):
    """A layer's state dict as numpy copies (a CPU tensor's ``numpy()``
    shares its memory)."""
    out = {}
    for k, v in layer.state_dict().items():
        out[k] = np.array(v.detach().cpu().numpy() if isinstance(
            v, torch.Tensor) else v.numpy())
    return out


def _run(pkg, layer, x, steps=3):
    """Forward, loss.backward(), the gradients, then ``steps`` Adam steps
    (each its own forward and backward) and the parameters after."""
    t = (pkg.to_tensor(x, place="cpu") if pkg is pt else pkg.to_tensor(x))
    out = layer(t)
    loss = pkg.mean(out * out)
    loss.backward()
    grads = {k: np.array(p.grad.numpy()) for k, p in layer.named_parameters()}
    opt = pkg.optimizer.Adam(learning_rate=1e-3,
                             parameters=layer.parameters())
    opt.step()
    opt.clear_grad()
    for _ in range(steps - 1):
        o = layer(t)
        pkg.mean(o * o).backward()
        opt.step()
        opt.clear_grad()
    after = _arrays(layer)
    if pkg is pt:
        out, loss = out.detach(), loss.detach()
    return np.asarray(out.numpy()), float(loss), grads, after


@pytest.fixture(scope="module")
def pair():
    with cs.using_device("cpu"):
        pt.seed(0)
        mine = cs.user_decoder_layer(pt, HIDDEN, HEADS, FFN)
        theirs = cs.user_decoder_layer(paddle, HIDDEN, HEADS, FFN)
        weights = _arrays(mine)
        assert set(weights) == set(theirs.state_dict())
        missing, unexpected = theirs.set_state_dict(weights)
        assert not missing and not unexpected
        x = np.random.default_rng(0).standard_normal(
            (2, TOKENS, HIDDEN)).astype(np.float32)
        yield _run(pt, mine, x), _run(paddle, theirs, x), weights


def test_user_decoder_layer_matches_jax(pair):
    (out, loss, grads, after), (j_out, j_loss, j_grads, j_after), _ = pair
    assert _rel(out, j_out) < RTOL
    assert abs(loss - j_loss) <= RTOL * abs(j_loss)
    assert set(grads) == set(j_grads)
    for k in grads:
        assert _rel(grads[k], j_grads[k]) < RTOL, k
    for k in after:
        assert _rel(after[k], j_after[k]) < RTOL, k


def test_the_steps_moved_every_parameter(pair):
    (_, _, _, after), _, before = pair
    for k in after:
        assert not np.array_equal(after[k], before[k]), k


def test_user_layer_matches_llama_decoder_layer():
    """The same user layer holds the port's ``LlamaDecoderLayer`` weights
    (phase 26b's check at tiny width): outputs and gradients within
    1e-5."""
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaDecoderLayer)
    cfg = LlamaConfig(hidden_size=HIDDEN, intermediate_size=FFN,
                      num_attention_heads=HEADS, num_key_value_heads=HEADS,
                      dtype="float32")
    pt.seed(3)
    ref = LlamaDecoderLayer(cfg, device="cpu")
    user = cs.user_decoder_layer(pt, HIDDEN, HEADS, FFN, cfg.rms_norm_eps,
                                 cfg.rope_theta)
    load_numpy_state_dict(user, {k: v.detach().numpy()
                                 for k, v in ref.state_dict().items()})
    x = torch.randn(2, TOKENS, HIDDEN, generator=torch.Generator().manual_seed(
        0))
    a, b = ref(x), user(x)
    assert _rel(b.detach(), a.detach()) < RTOL
    torch.mean(a * a).backward()
    torch.mean(b * b).backward()
    refp = dict(ref.named_parameters())
    for k, p in user.named_parameters():
        assert _rel(p.grad, refp[k].grad) < RTOL, k


def _tree(pkg):
    """A small tree: an fc, a buffer of each persistence, a child Layer
    with a parameter of every ParamAttr form, and the port's own
    ``nn.Linear`` as a child."""
    class Child(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [3, 2], attr=pkg.ParamAttr(
                    initializer=pkg.nn.initializer.Constant(0.5),
                    learning_rate=0.5))
            self.frozen = self.create_parameter(
                [2], attr=pkg.ParamAttr(trainable=False), is_bias=True)
            self.none = self.create_parameter([2], attr=False)

        def forward(self, x):
            return pkg.matmul(x, self.w)

    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__(name_scope="netscope")
            self.fc = pkg.nn.Linear(4, 3)
            self.child = Child()
            self.register_buffer("kept", pkg.to_tensor(
                np.ones(2, np.float32), **({"place": "cpu"} if pkg is pt
                                           else {})))
            self.register_buffer("dropped", pkg.to_tensor(
                np.zeros(2, np.float32), **({"place": "cpu"} if pkg is pt
                                            else {})), persistable=False)
            self.add_sublayer("extra", pkg.nn.Linear(2, 3))
            self.add_parameter("scale", self.create_parameter(
                [1], default_initializer=pkg.nn.initializer.Constant(2.0)))

        def forward(self, x):
            return self.extra(self.child(self.fc(x))) * self.scale

    return Net()


def test_layer_surface_matches_jax():
    pt.seed(1)
    mine, theirs = _tree(pt), _tree(paddle)
    assert [k for k, _ in mine.named_parameters()] == \
        [k for k, _ in theirs.named_parameters()]
    assert isinstance(mine.parameters(), list)
    assert len(mine.parameters()) == len(theirs.parameters())
    assert sorted(mine.state_dict()) == sorted(theirs.state_dict())
    assert "dropped" not in mine.state_dict()
    assert [k for k, _ in mine.named_buffers()] == \
        [k for k, _ in theirs.named_buffers()]
    assert len(mine.buffers()) == len(theirs.buffers()) == 2
    assert [k for k, _ in mine.named_sublayers()] == \
        [k for k, _ in theirs.named_sublayers()]
    assert len(mine.sublayers()) == len(theirs.sublayers())
    assert len(mine.sublayers(include_self=True)) == len(mine.sublayers()) + 1
    assert [type(c).__name__ for c in mine.children()] == \
        [type(c).__name__ for c in theirs.children()]
    assert sorted(mine.state_dict(include_sublayers=False)) == \
        sorted(theirs.state_dict(include_sublayers=False))
    assert sorted(mine.state_dict(structured_name_prefix="m")) == \
        sorted(theirs.state_dict(structured_name_prefix="m"))
    # ParamAttr: the initializer, trainable, no parameter, the lr factor
    np.testing.assert_array_equal(mine.child.w.detach().numpy(),
                                  theirs.child.w.numpy())
    assert not mine.child.frozen.requires_grad
    assert theirs.child.frozen.stop_gradient
    assert mine.child.none is None and theirs.child.none is None
    assert mine.child.w.optimize_attr["learning_rate"] == \
        theirs.child.w.optimize_attr["learning_rate"] == 0.5
    assert mine.full_name().startswith("netscope_")
    assert theirs.full_name().startswith("netscope_")
    # set_state_dict: (missing, unexpected), shape mismatch raises
    sd = {k: np.full(v.shape, 0.25, np.float32)
          for k, v in _arrays(mine).items()}
    sd.pop("fc.bias")
    sd["nope"] = np.zeros(1, np.float32)
    assert mine.set_state_dict(sd) == tuple(theirs.set_state_dict(sd))
    assert float(mine.fc.weight[0, 0]) == 0.25
    with pytest.raises(ValueError):
        mine.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError):
        theirs.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})
    # train/eval and apply reach the port's own modules
    mine.eval()
    assert not mine.fc.training and not mine.child.training
    mine.train()
    assert mine.extra.training
    seen = []
    mine.apply(lambda m: seen.append(type(m).__name__))
    jseen = []
    theirs.apply(lambda m: jseen.append(type(m).__name__))
    assert seen == jseen


def test_parameter_learning_rate_scales_adam_as_jax_does():
    pt.seed(2)
    mine, theirs = _tree(pt), _tree(paddle)
    theirs.set_state_dict(_arrays(mine))
    x = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    for pkg, net, t in ((pt, mine, pt.to_tensor(x, place="cpu")),
                        (paddle, theirs, paddle.to_tensor(x))):
        opt = pkg.optimizer.Adam(learning_rate=0.1,
                                 parameters=net.parameters())
        for _ in range(2):
            pkg.sum(net(t)).backward()
            opt.step()
            opt.clear_grad()
    a, b = _arrays(mine), _arrays(theirs)
    for k in a:
        assert _rel(a[k], b[k]) < RTOL, k


def test_hooks_dtype_moves_and_clear_gradients():
    pt.seed(4)
    net = _tree(pt)
    x = pt.to_tensor(np.ones((2, 4), np.float32), place="cpu")
    calls = []
    pre = net.register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2,))
    post = net.register_forward_post_hook(
        lambda layer, inputs, out: calls.append(out.shape) or out + 1)
    doubled = net(x)
    pre.remove()
    post.remove()
    plain = net(x * 2)
    np.testing.assert_allclose(doubled.detach().numpy(),
                               plain.detach().numpy() + 1, rtol=1e-6)
    assert calls == [plain.shape]
    pt.sum(net(x)).backward()
    assert net.fc.weight.grad is not None
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    assert net.to(dtype="bfloat16").fc.weight.dtype == torch.bfloat16
    assert net.kept.dtype == torch.bfloat16
    assert net.float().fc.weight.dtype == torch.float32
    assert net.astype("float64").child.w.dtype == torch.float64
    assert net.bfloat16().scale.dtype == torch.bfloat16
    assert net.to("cpu") is net
    v = net.create_variable(dtype="int32")
    assert v.shape == () and v.dtype == torch.int32
    with pytest.raises(TypeError):
        net.add_parameter("bad", torch.zeros(1))


def test_parameters_go_to_the_framework_device():
    """Without ``set_device("cpu")`` a Layer's parameters go to CUDA, and
    without CUDA creating one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with cs.using_device("cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.nn.Layer().create_parameter([2])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.create_parameter([2], "float32")
