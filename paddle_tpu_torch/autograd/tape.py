"""Grad modes and ``backward``. Counterpart of
``paddle_tpu/autograd/tape.py``: the JAX package records its own tape;
the port's tensors are torch's, so these are torch's grad modes, and
``backward`` runs torch's reverse pass with paddle's seeding rule, in a
``train.backward`` span while tracing is on (``loss.backward()``, which is
torch's, gets the same span from ``observability.tracing``'s hook).
"""
from __future__ import annotations

import torch

from ..observability import tracing as _tracing

__all__ = ["backward", "enable_grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` (one or a list) into the
    ``.grad`` of the leaves that require grad. A missing grad tensor
    seeds ones of its tensor's shape, for any shape (paddle's rule;
    torch's own ``backward`` takes no seed only for a scalar)."""
    ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
    if grad_tensors is None or isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors] * len(ts) if grad_tensors is None \
            else [grad_tensors]
    seeds = [torch.ones_like(t) if g is None else g.to(t.device, t.dtype)
             for t, g in zip(ts, grad_tensors)]
    for t in ts:
        if not t.requires_grad:
            raise RuntimeError(
                "Tensor has no grad graph; it was computed under no_grad or "
                "all inputs have stop_gradient=True")
    if _tracing._ENABLED:
        with _tracing.span("train.backward", cat="train"):
            torch.autograd.backward(ts, seeds, retain_graph=retain_graph)
        return
    torch.autograd.backward(ts, seeds, retain_graph=retain_graph)
