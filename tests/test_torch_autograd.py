"""The port's autograd against the JAX package's: every case of
``tests/test_autograd.py`` (the eager tape, ``PyLayer``, the functional
transforms, ``Jacobian``/``Hessian``/``forward_grad``) written once and
run through both packages, plus the grad modes, ``backward`` with several
roots, a ``PyLayer`` with two inputs and a non-tensor argument, and the
functional transforms' other forms (``value_and_grad``, ``has_aux``,
``vjp``, ``jvp``, several inputs). Results agree within 1e-5 relative.

The port's tensors are torch's: ``loss.backward()`` on a non-scalar needs
a seed in torch, so the cases seed through ``autograd.backward``, which
takes paddle's rule (ones of any shape) in both packages; a gradient is
cleared with ``x.grad = None`` (paddle's ``x.clear_grad()``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.autograd import PyLayer as JaxPyLayer
from paddle_tpu.incubate import autograd as jax_incubate

TOL = dict(rtol=1e-5, atol=1e-6)


class JaxSide:
    P = paddle
    PyLayer = JaxPyLayer
    A = paddle.autograd
    incubate = jax_incubate

    def t(self, data, stop_gradient=True):
        return paddle.to_tensor(np.asarray(data, np.float32),
                                stop_gradient=stop_gradient)

    def backward(self, y, g=None):
        y.backward(g)

    def grad(self, x):
        return None if x.grad is None else x.grad.numpy()

    def clear(self, x):
        x.clear_grad()

    def np(self, y):
        return np.asarray(y.numpy())

    def tracked(self, y):
        return y._node is not None and not y.stop_gradient


class PortSide:
    P = pt
    PyLayer = pt.autograd.PyLayer
    A = pt.autograd
    incubate = pt.autograd

    def t(self, data, stop_gradient=True):
        return pt.to_tensor(np.asarray(data, np.float32), place="cpu",
                            stop_gradient=stop_gradient)

    def backward(self, y, g=None):
        pt.autograd.backward(y, g)

    def grad(self, x):
        return None if x.grad is None else x.grad.numpy()

    def clear(self, x):
        x.grad = None

    def np(self, y):
        return y.detach().numpy()

    def tracked(self, y):
        return y.requires_grad


def backward_simple(S):
    x = S.t([2.0, 3.0], stop_gradient=False)
    S.backward(S.P.sum(x * x))
    return [S.grad(x)]


def backward_chain(S):
    x = S.t([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    w = S.t([[0.5, -0.5], [1.0, 2.0]], stop_gradient=False)
    loss = S.P.mean(S.P.tanh(S.P.matmul(x, w)) ** 2)
    S.backward(loss)
    return [S.np(loss), S.grad(x), S.grad(w)]


def grad_accumulation(S):
    x = S.t([1.0], stop_gradient=False)
    S.backward(x * 2)
    S.backward(x * 3)
    g = S.grad(x)
    S.clear(x)
    return [g, np.asarray(S.grad(x) is None)]


def stop_gradient(S):
    x = S.t([1.0], stop_gradient=False)
    y = S.t([2.0])
    S.backward(S.P.sum(x * y))
    return [S.grad(x), np.asarray(S.grad(y) is None)]


def no_grad(S):
    x = S.t([1.0], stop_gradient=False)
    with S.P.no_grad():
        y = x * 5
    return [np.asarray(S.tracked(y)), S.np(y)]


def detach(S):
    x = S.t([1.0, 2.0], stop_gradient=False)
    y = (x * 2).detach()
    S.backward(S.P.sum(y * x))
    return [np.asarray(S.tracked(y)), S.grad(x)]


def multi_output_op(S):
    x = S.t(np.arange(6, dtype=np.float32).reshape(2, 3),
            stop_gradient=False)
    a, b, c = S.P.split(x, 3, axis=1)
    S.backward(S.P.sum(a * 1 + b * 2 + c * 3))
    return [S.grad(x)]


def branching_graph(S):
    x = S.t([2.0], stop_gradient=False)
    S.backward(S.P.sum((x * 3) * (x * 4)))
    return [S.grad(x)]


def functional_grad(S):
    def f(x):
        return S.P.sum(S.P.sin(x) * x)
    return [S.np(S.P.grad(f)(S.t([1.0, 2.0])))]


class _Cube:
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x * x

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensor()
        return dy * 3 * x * x


def py_layer(S):
    Cube = type("Cube", (S.PyLayer,), dict(_Cube.__dict__))
    x = S.t([2.0], stop_gradient=False)
    y = Cube.apply(x)
    S.backward(S.P.sum(y))
    return [S.np(y), S.grad(x)]


def backward_nonscalar_with_grad_tensor(S):
    x = S.t([1.0, 2.0], stop_gradient=False)
    S.backward(x * x, S.t([1.0, 10.0]))
    return [S.grad(x)]


def second_order_via_functional(S):
    def f(x):
        return S.P.sum(x ** 3)
    return [S.np(S.A.hessian(f, S.t([1.0, 2.0])))]


def incubate_jacobian_hessian_forward_grad(S):
    x = S.t([1.0, 2.0])
    J = S.incubate.Jacobian(lambda t: t ** 2, x)
    H = S.incubate.Hessian(lambda t: S.P.sum(t ** 3), x)
    tangent = S.incubate.forward_grad(lambda t: t ** 2, x, S.t([1.0, 0.0]))
    return [S.np(J[:]), np.asarray(J.shape), S.np(J[0]), S.np(H[:]),
            S.np(tangent)]


def py_layer_two_inputs(S):
    class Mul(S.PyLayer):
        @staticmethod
        def forward(ctx, a, b, k):
            ctx.save_for_backward(a, b)
            ctx.k = k
            return a * b * k

        @staticmethod
        def backward(ctx, dy):
            a, b = ctx.saved_tensor()
            return dy * b * ctx.k, dy * a * ctx.k

    a = S.t([1.0, 2.0, 3.0], stop_gradient=False)
    b = S.t([4.0, 5.0, 6.0], stop_gradient=False)
    y = Mul.apply(a, b, 2.0)
    S.backward(S.P.sum(y * y))
    return [S.np(y), S.grad(a), S.grad(b)]


def functional_forms(S):
    def f(x, y):
        return S.P.sum(S.P.tanh(x) * y)

    def f_aux(x):
        return S.P.sum(x * x), S.P.mean(x)

    x, y = S.t([0.5, -1.0, 2.0]), S.t([1.0, 2.0, 3.0])
    gx, gy = S.P.grad(f, argnums=(0, 1))(x, y)
    v, g = S.A.value_and_grad(f)(x, y)
    (va, aux), ga = S.A.value_and_grad(f_aux, has_aux=True)(x)
    out, vj = S.A.vjp(lambda t: S.P.sin(t) * 2, x, S.t([1.0, 0.5, 2.0]))
    out2, jv = S.A.jvp(lambda t: S.P.exp(t), x, S.t([1.0, 0.0, 1.0]))
    jx, jy = S.A.jacobian(lambda a, b: a * b, [x, y])
    return [S.np(gx), S.np(gy), S.np(v), S.np(g), S.np(va), S.np(aux),
            S.np(ga), S.np(out), S.np(vj), S.np(out2), S.np(jv), S.np(jx),
            S.np(jy)]


def grad_modes(S):
    x = S.t([1.0], stop_gradient=False)
    seen = []
    with S.P.no_grad():
        seen.append(S.P.is_grad_enabled())
        with S.P.enable_grad():
            seen.append(S.P.is_grad_enabled())
            y = x * 2
    with S.P.set_grad_enabled(False):
        seen.append(S.P.is_grad_enabled())
        z = x * 3
    seen.append(S.P.is_grad_enabled())
    return [np.asarray(seen), np.asarray([S.tracked(y), S.tracked(z)])]


CASES = [backward_simple, backward_chain, grad_accumulation, stop_gradient,
         no_grad, detach, multi_output_op, branching_graph, functional_grad,
         py_layer, backward_nonscalar_with_grad_tensor,
         second_order_via_functional,
         incubate_jacobian_hessian_forward_grad, py_layer_two_inputs,
         functional_forms, grad_modes]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_jax(case):
    want = case(JaxSide())
    got = case(PortSide())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **TOL)


def test_backward_seeds_several_roots_and_refuses_an_untracked_one():
    x = pt.to_tensor([1.0, 2.0], place="cpu", stop_gradient=False)
    pt.autograd.backward([x * x, x * 3], [None, pt.to_tensor(
        [1.0, 2.0], place="cpu")])
    np.testing.assert_allclose(x.grad.numpy(), [2 + 3, 4 + 6])
    with pytest.raises(RuntimeError, match="no grad graph"):
        pt.autograd.backward(pt.to_tensor([1.0], place="cpu"))


def test_py_layer_materialize_grads_and_no_grad():
    seen = []

    class Two(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.materialize_grads = True
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, da, db):
            seen.append(float(db.abs().sum()))
            return da * 2 + db * 3

    x = pt.to_tensor([1.0, 2.0], place="cpu", stop_gradient=False)
    a, _ = Two.apply(x)
    pt.autograd.backward(pt.sum(a))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
    assert seen == [0.0]                # the unused output's zeros
    with pt.no_grad():
        a, b = Two.apply(x)
    assert not a.requires_grad and not b.requires_grad
    assert isinstance(torch.Tensor(), pt.Tensor)
