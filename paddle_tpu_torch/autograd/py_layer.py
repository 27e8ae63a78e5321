"""PyLayer: a user-written forward and backward. Counterpart of
``paddle_tpu/autograd/py_layer.py``, over ``torch.autograd.Function``::

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor()
            return 3 * x ** 2 * dy

``forward`` runs without recording; ``backward`` returns one gradient per
tensor input (or one per input that requires grad, the JAX package's
reading), None for none. ``ctx.materialize_grads`` (True by default)
turns a missing output gradient into zeros before ``backward`` sees it.
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What ``forward`` leaves for ``backward``: ``save_for_backward``'s
    tensors, ``saved_tensor()``, and any attribute set on it."""

    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext()
        out = layer.forward(pctx, *args, **kwargs)
        saved = pctx._saved
        slots = [i for i, t in enumerate(saved)
                 if isinstance(t, torch.Tensor)]
        ctx.save_for_backward(*(saved[i] for i in slots))
        ctx.pctx, ctx.slots, ctx.layer = pctx, slots, layer
        ctx.tensor_args = [i for i, a in enumerate(args)
                           if isinstance(a, torch.Tensor)]
        ctx.set_materialize_grads(bool(pctx.materialize_grads))
        return out

    @staticmethod
    def backward(ctx, *grads):
        pctx = ctx.pctx
        saved = list(pctx._saved)
        for i, t in zip(ctx.slots, ctx.saved_tensors):
            saved[i] = t
        pctx._saved = tuple(saved)
        got = ctx.layer.backward(pctx, *grads)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        n_args = len(ctx.needs_input_grad) - 2
        out = [None] * n_args
        targets = ctx.tensor_args
        if len(got) != len(targets):
            targets = [i for i in ctx.tensor_args
                       if ctx.needs_input_grad[i + 2]]
        if len(got) != len(targets):
            raise ValueError(
                f"{ctx.layer.__name__}.backward returned {len(got)} "
                f"gradients for {len(ctx.tensor_args)} tensor inputs")
        for i, g in zip(targets, got):
            out[i] = g
        return (None, None, *out)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Function.apply(cls, kwargs, *args)
