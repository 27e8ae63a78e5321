"""Helpers of the ``nn`` layer library's parity tests
(``test_torch_nn_functional.py``, ``test_torch_nn_layers.py``,
``test_torch_rnn.py``): a row of ``chip_smoke.nn_cases`` through the JAX
package (a functional row as the op table's ``jax_op`` runs it; a layer
row built with constant weights, given the port layer's state dict, and
its gradients taken for the input and every parameter by name), and the
check that holds the port's run to it."""
import numpy as np
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu_torch.nn import layer as pt_layer
from paddle_tpu_torch.nn.functional import extension, loss, pooling, vision

from torch_parity import constant_init

CPU_ROWS = cs.NN_ROWS_CPU
_VISION = set(pooling.__all__ + vision.__all__ + extension.__all__)


def group(case):
    """Which test file holds a row: "functional", "loss", "vision",
    "activations", "layers" or "rnn"."""
    kind, name = case.name.split(".", 1)
    if kind == "F":
        return ("loss" if name in loss.__all__ else
                "vision" if name in _VISION else "functional")
    if name.endswith("Loss"):
        return "loss"
    if name in pt_layer.rnn.__all__:
        return "rnn"
    if name in pt_layer.activation.__all__:
        return "activations"
    return "vision" if name.startswith("MaxUnPool") else "layers"


def cases(which):
    return [c for c in cs.nn_cases(CPU_ROWS) if group(c) == which]


def _numpy(o):
    if isinstance(o, JTensor):
        a = np.asarray(o._data)
        return (a.astype(np.float32) if a.dtype.name == "bfloat16" else a,
                str(a.dtype))
    return np.asarray(o), type(o).__name__


def state_arrays(layer):
    """A layer's state dict as numpy copies, port or JAX."""
    return {k: np.array(v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v._data))
        for k, v in layer.state_dict().items()}


def jax_layer(case, port_layer=None):
    """The JAX layer of a "nn." row, holding ``port_layer``'s weights."""
    ctor = [a(paddle.nn) if callable(a) else a for a in case.ctor]
    with constant_init():
        layer = getattr(paddle.nn, case.name[3:])(*ctor, **case.kw)
    if port_layer is not None:
        layer.set_state_dict(state_arrays(port_layer))
    return layer


def jax_row(case, args, grad, port_layer=None, names=()):
    """(outputs as numpy, dtype names, gradients) of a row through the JAX
    package: the gradient of ``sum(y * w)`` for the first float input, and
    for a layer row then every parameter in ``names``' order, each beside
    the number of terms it sums."""
    if case.name.startswith("nn."):
        fn = jax_layer(case, port_layer)
    else:
        F = paddle.nn.functional
        fn = getattr(F, case.name[2:], None) or getattr(F.loss,
                                                        case.name[2:])
    slot = cs.grad_slot(args) if grad else None
    leaf = []

    def mark(a):
        t = paddle.to_tensor(a, stop_gradient=False)
        leaf.append(t)
        return t

    out = fn(*cs.convert_args(args, paddle.to_tensor, slot, mark),
             **({} if case.name.startswith("nn.") else case.kw))
    outs = cs.flat_outputs(out)
    grads = None
    if slot is not None:
        y = next(o for o in outs if isinstance(o, JTensor)
                 and np.dtype(o.dtype).kind == "f"
                 and not o.stop_gradient)
        paddle.sum(y * paddle.to_tensor(cs.weights_for(tuple(y.shape)))
                   ).backward()
        params = dict(fn.named_parameters()) if names else {}
        grads = []
        for t in leaf + [params[n] for n in names]:
            g = (np.zeros(t.shape, np.float32) if t.grad is None
                 else np.asarray(t.grad.numpy()).astype(np.float32))
            grads.append((g, max(1, y.size // max(1, int(np.prod(
                t.shape))))))
    arrays, dtypes = zip(*(_numpy(o) for o in outs)) if outs else ((), ())
    return list(arrays), list(dtypes), grads


def check_row(case, args, port, want):
    """None when the port's run of a row matches the JAX package's:
    dtypes (after JAX's 64 -> 32), outputs within the row's class, every
    gradient within ``GRAD_TOL``."""
    if [cs._map64(d) for d in port[1]] != want[1]:
        return f"dtypes {port[1]} vs {want[1]}"
    err = cs.compare_op(case, args, port[0], want[0])
    if err:
        return err
    got_g = port[2]
    if got_g is not None and not isinstance(got_g, list):
        got_g = [(got_g, port[3])]
    return cs.compare_nn_grads(case, got_g, want[2])


def run_row(case):
    """None when a row of the nn table matches the JAX package on the
    CPU (and a layer row's state dict keys are JAX's), else what
    differs."""
    args = cs.op_args(case, CPU_ROWS)
    if not case.name.startswith("nn."):
        want = jax_row(case, args, case.grad)
        return check_row(case, args, cs.port_nn(pt, case, args, "cpu",
                                                grad=case.grad), want)
    layer = cs.build_layer(pt, case, "cpu")
    names = [n for n, _ in layer.named_parameters()]
    jl = jax_layer(case, layer)
    if list(jl.state_dict()) != list(layer.state_dict()):
        return f"keys {list(layer.state_dict())} vs {list(jl.state_dict())}"
    want = jax_row(case, args, case.grad, layer, names)
    got = cs.port_nn(pt, case, args, "cpu", grad=case.grad, layer=layer)
    return check_row(case, args, got, want)
