"""Functional autograd. Counterpart of
``paddle_tpu/autograd/functional.py``, over ``torch.func``, with the JAX
package's signatures: ``grad(func, argnums=0, has_aux=False)`` and
``value_and_grad`` return functions of the same arguments as ``func``;
``vjp``, ``jvp``, ``jacobian`` and ``hessian`` take the inputs ``xs`` (a
tensor or a list of them); ``Jacobian`` and ``Hessian`` are lazy full
matrices (rows the flattened output, columns every input's flattened
elements, concatenated; ``is_batched=True`` keeps a leading batch dim);
``forward_grad`` is ``jvp``'s tangent. Python scalars and numpy inputs
become tensors by ``to_tensor``'s rules.
"""
from __future__ import annotations

import math

import torch
import torch.func as tf

from ..tensor_ops._factory import tensor

__all__ = ["Hessian", "Jacobian", "forward_grad", "grad", "hessian",
           "jacobian", "jvp", "value_and_grad", "vjp"]


def _args(xs):
    """The inputs as a tuple of tensors (``xs`` a tensor or a sequence)."""
    if isinstance(xs, (tuple, list)):
        return tuple(tensor(x) for x in xs)
    return (tensor(xs),)


def _argnums(n):
    return tuple(range(n)) if n > 1 else 0


def grad(func, argnums=0, has_aux=False):
    """The gradient of a scalar ``func`` with respect to ``argnums``."""
    gfn = tf.grad(func, argnums=argnums, has_aux=has_aux)

    def wrapper(*args):
        return gfn(*(tensor(a) for a in args))
    return wrapper


def value_and_grad(func, argnums=0, has_aux=False):
    """``(value, grad)`` (``((value, aux), grad)`` with ``has_aux``)."""
    gfn = tf.grad_and_value(func, argnums=argnums, has_aux=has_aux)

    def wrapper(*args):
        g, value = gfn(*(tensor(a) for a in args))
        return value, g
    return wrapper


def vjp(func, xs, v=None):
    """``(func(*xs), v^T J)``; ``v`` defaults to ones of the output's
    shape; one cotangent per input (a single one unwrapped)."""
    out, vjp_fn = tf.vjp(func, *_args(xs))
    if v is None:
        v = (tuple(torch.ones_like(o) for o in out)
             if isinstance(out, tuple) else torch.ones_like(out))
    elif isinstance(v, (tuple, list)):
        v = tuple(tensor(t) for t in v)
    else:
        v = tensor(v)
    gs = vjp_fn(v)
    return out, gs if len(gs) > 1 else gs[0]


def jvp(func, xs, v=None):
    """``(func(*xs), J v)``; ``v`` defaults to ones of the inputs'
    shapes."""
    primals = _args(xs)
    if v is None:
        tangents = tuple(torch.ones_like(p) for p in primals)
    else:
        tangents = _args(v)
    return tf.jvp(func, primals, tangents)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """``func``'s Jacobian: one block (output shape + input shape) per
    input, a tuple for several inputs."""
    args = _args(xs)
    return tf.jacrev(func, argnums=_argnums(len(args)))(*args)


def hessian(func, xs, create_graph=False, allow_unused=False):
    args = _args(xs)
    return tf.hessian(func, argnums=_argnums(len(args)))(*args)


def _prod(shape):
    return int(math.prod(shape))


class Jacobian:
    """A lazy Jacobian, computed (``jacrev``) on first access and indexed
    like the full matrix ``[prod(out_shape), sum_i prod(in_shape_i)]``;
    ``is_batched=True`` maps over the leading batch dim and gives
    ``[B, prod(out[1:]), sum_i prod(in_i[1:])]``."""

    def __init__(self, func, xs, is_batched=False):
        self._func = func
        self._xs = xs
        self._is_batched = is_batched
        self._jac = None

    def _materialize(self):
        if self._jac is not None:
            return self._jac
        args = _args(self._xs)
        jfn = tf.jacrev(self._func, argnums=_argnums(len(args)))
        jac = tf.vmap(jfn)(*args) if self._is_batched else jfn(*args)
        blocks = jac if isinstance(jac, tuple) else (jac,)
        if self._is_batched:
            b = args[0].shape[0]
            flat = [blk.reshape(b, -1, _prod(a.shape[1:]))
                    for blk, a in zip(blocks, args)]
        else:
            flat = [blk.reshape(-1, _prod(a.shape))
                    for blk, a in zip(blocks, args)]
        self._jac = torch.cat(flat, dim=-1)
        return self._jac

    @property
    def shape(self):
        return tuple(self._materialize().shape)

    def __getitem__(self, idx):
        return self._materialize()[idx]

    def numpy(self):
        return self._materialize().detach().cpu().numpy()


class Hessian:
    """A lazy Hessian of a scalar ``func``: the square block matrix over
    every input's flattened elements; ``is_batched=True`` maps per sample
    (``[B, n, n]``)."""

    def __init__(self, func, xs, is_batched=False):
        self._func = func
        self._xs = xs
        self._is_batched = is_batched
        self._hes = None

    @staticmethod
    def _assemble(h, args, batch=None):
        lead = (batch,) if batch else ()
        skip = 1 if batch else 0
        sizes = [_prod(a.shape[skip:]) for a in args]
        if not isinstance(h, tuple):
            return h.reshape(*lead, sizes[0], sizes[0])
        rows = [torch.cat([blk.reshape(*lead, sizes[i], sizes[j])
                           for j, blk in enumerate(hrow)], dim=-1)
                for i, hrow in enumerate(h)]
        return torch.cat(rows, dim=-2)

    def _materialize(self):
        if self._hes is not None:
            return self._hes
        args = _args(self._xs)
        hfn = tf.hessian(self._func, argnums=_argnums(len(args)))
        if self._is_batched:
            self._hes = self._assemble(tf.vmap(hfn)(*args), args,
                                       batch=args[0].shape[0])
        else:
            self._hes = self._assemble(hfn(*args), args)
        return self._hes

    @property
    def shape(self):
        return tuple(self._materialize().shape)

    def __getitem__(self, idx):
        return self._materialize()[idx]

    def numpy(self):
        return self._materialize().detach().cpu().numpy()


def forward_grad(func, xs, v=None):
    """The forward-mode derivative ``J v`` (``jvp``'s tangent)."""
    return jvp(func, xs, v)[1]
