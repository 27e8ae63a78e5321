"""Autograd. Counterpart of ``paddle_tpu/autograd``, on torch's autograd.

The grad modes and ``backward`` are in ``tape.py``, ``PyLayer`` in
``py_layer.py``, the functional transforms (JAX's signatures:
``grad(func, argnums, has_aux)``, not reference paddle's
``grad(outputs, inputs)``) in ``functional.py``, over ``torch.func``.
"""
from .functional import (Hessian, Jacobian, forward_grad, grad, hessian,
                         jacobian, jvp, value_and_grad, vjp)
from .py_layer import PyLayer, PyLayerContext
from .tape import (backward, enable_grad, is_grad_enabled, no_grad,
                   set_grad_enabled)

__all__ = ["Hessian", "Jacobian", "PyLayer", "PyLayerContext", "backward",
           "enable_grad", "forward_grad", "grad", "hessian",
           "is_grad_enabled", "jacobian", "jvp", "no_grad",
           "set_grad_enabled", "value_and_grad", "vjp"]
