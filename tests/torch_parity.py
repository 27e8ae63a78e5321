"""Helpers shared by the model-family parity tests of the PyTorch port
(``test_torch_bert.py``, ``test_torch_t5.py``, ``test_torch_vit.py``,
``test_torch_convert.py``): a model's weights as numpy arrays, a JAX
model holding a port model's weights, a JAX call traced once under
``jax.jit``, three fleet + AdamW steps on either side, the parameter rule those steps are held to, and a one-thread
context for torch (the tiny models' ops are far faster on one thread
than spread over eight)."""
import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.autograd.tape import functional_mode
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.nn import initializer as jax_init
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import load_numpy_state_dict

FWD_TOL = dict(rtol=1e-5, atol=1e-5)    # fp32 forwards
LOSS_RTOL = 2e-4                        # losses over 3 steps
PARAM_RTOL = 2e-4                       # parameters after the steps
LR = 1e-3
STEPS = 3


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op threads at ``n`` inside, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def arrays(model):
    """A model's state dict as float32 numpy arrays (JAX or port)."""
    out = {}
    for k, v in model.state_dict().items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().float().cpu().numpy()
        else:
            out[k] = np.asarray(v._data).astype(np.float32)
    return out


def port_copy(make_port, jax_model):
    """A port model from ``make_port()`` holding ``jax_model``'s weights."""
    model = make_port()
    load_numpy_state_dict(model, arrays(jax_model))
    return model


@contextlib.contextmanager
def constant_init():
    """JAX layers built inside draw no random numbers (every parameter
    starts at 0): the JAX random initialisers compile for every shape,
    seconds a model, and the weights are replaced anyway."""
    jax_init.set_global_initializer(jax_init.Constant(0.0),
                                    jax_init.Constant(0.0))
    try:
        yield
    finally:
        jax_init.set_global_initializer(None, None)


def jax_copy(make_jax, port_model):
    """A JAX model from ``make_jax()`` holding ``port_model``'s weights
    (the parameter names are the same in both packages)."""
    with constant_init():
        jm = make_jax()
    params = dict(jm.named_parameters())
    src = {k: v.detach().float().numpy()
           for k, v in port_model.named_parameters()}
    assert params.keys() == src.keys()
    for k, p in params.items():
        p._data = jnp.asarray(src[k], dtype=p._data.dtype)
    return jm


def jax_call(fn, *args):
    """``fn`` on JAX Tensors made from ``args`` (arrays or None), traced
    once under ``jax.jit`` (the JAX layers' eager ops would each compile
    on their own); returns numpy arrays in the structure ``fn`` returns."""
    def f(*xs):
        with functional_mode():
            out = fn(*(None if x is None else JTensor(x) for x in xs))
        return jax.tree_util.tree_map(
            lambda t: t._data if isinstance(t, JTensor) else t, out,
            is_leaf=lambda t: isinstance(t, JTensor))
    out = jax.jit(f)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def jax_train(model, loss_fn, *batch):
    """(initial weights, losses, final weights) of ``STEPS`` JAX fleet +
    AdamW(``LR``) steps on one repeated batch."""
    jax_mesh.set_mesh(None)
    try:
        s = jax_fleet.DistributedStrategy()
        jax_fleet.init(is_collective=True, strategy=s)
        model = jax_fleet.distributed_model(model)
        init = arrays(model)
        opt = jax_fleet.distributed_optimizer(
            jax_optim.AdamW(learning_rate=LR, parameters=model.parameters()),
            strategy=s)
        step = opt.make_train_step(model, loss_fn)
        # the step's scaler state comes back placed on the mesh: place it
        # so before the first call, or the second call compiles again
        rep = jax.sharding.NamedSharding(step._mesh,
                                         jax.sharding.PartitionSpec())
        step._scaler_state = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), step._scaler_state)
        xs = [paddle.to_tensor(b) for b in batch]
        losses = [float(step(*xs).numpy()) for _ in range(STEPS)]
        return init, losses, arrays(model)
    finally:
        jax_mesh.set_mesh(None)


def port_train(model, loss_fn, *batch):
    """(losses, final weights) of the same steps on the port."""
    s = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(learning_rate=LR, parameters=model.parameters()))
    step = opt.make_train_step(model, loss_fn)
    losses = [float(step(*batch)) for _ in range(STEPS)]
    return losses, arrays(model)


def assert_params_close(got, want, exempt=()):
    """``tests/test_torch_gpt_train.py``'s rule: every element within
    rtol ``PARAM_RTOL`` (atol 1e-6, for elements near zero) except at
    most 0.1% of them, none beyond 6 lr (Adam's first update is lr *
    sign(g), so an element whose gradient is at round-off level moves by
    up to 2 lr a step in either package); the names ending in one of
    ``exempt`` within 6 lr alone (a key bias: softmax cancels it, its
    true gradient is 0 and Adam moves it by up to lr a step either way on
    round-off gradients, on both sides: BERT_TINY's differ by up to 6.7e-4
    after 3 steps)."""
    assert got.keys() == want.keys()
    n = far = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith(exempt):
            np.testing.assert_allclose(g, w, rtol=0, atol=6 * LR,
                                       err_msg=k)
            continue
        diff = np.abs(g - w)
        assert diff.max() <= 6 * LR, (k, diff.max())
        far += int((diff > PARAM_RTOL * np.abs(w) + 1e-6).sum())
        n += diff.size
    assert far <= 1e-3 * n, (far, n)
