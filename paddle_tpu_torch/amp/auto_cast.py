"""Mixed precision: ``auto_cast`` and ``decorate``. Counterpart of
``paddle_tpu/amp/auto_cast.py``.

The policy is the JAX package's, not ``torch.autocast``'s: inside
``auto_cast`` the compute-heavy ops call ``maybe_cast_compute`` on their
operands, which casts fp32 tensors (only those) to the amp dtype (bf16,
or fp16 for any other ``dtype``). The product's result stays in that
dtype; a later fp32 + bf16 add promotes back to fp32, so residual
streams, norms and fp32 math outside the products stay as they were.
The cast sites are exactly the JAX package's: ``nn.functional.linear``
(and so every ``Linear``, the tensor-parallel ones included),
``nn.functional.conv2d`` (``Conv2D``) and ``tensor_ops.matmul`` (the
tied LM heads). Attention's inner products,
the MoE einsums and the fused LM head do not cast, as in JAX.

The white/black lists are accepted and ignored, as in JAX. ``level``
("O1" or "O2") is recorded; O2's difference is ``decorate``, which casts
a model's fp32 parameters to the amp dtype in place (the
``nn.Parameter`` objects stay, so an optimizer built before keeps its
references). The fp32 master copies are the optimizer's
``multi_precision`` masters; ``master_weight`` and ``save_dtype`` are
ignored, as in JAX.

The state is thread-local. A recompute that runs in the backward (remat)
re-enters the state its forward saw through ``amp_state_guard``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "amp_state", "amp_state_guard",
           "maybe_cast_compute", "decorate"]

_tls = threading.local()


def _amp_dtype(dtype):
    return torch.bfloat16 if dtype in ("bfloat16", "bf16", torch.bfloat16) \
        else torch.float16


def amp_state():
    """The active policy ``{"enable", "level", "dtype"}``, or None."""
    return getattr(_tls, "state", None)


@contextlib.contextmanager
def amp_state_guard(state):
    """Run the block under ``state`` (an ``amp_state()`` value, None for
    no amp), restoring the previous state after it."""
    prev = amp_state()
    _tls.state = state
    try:
        yield
    finally:
        _tls.state = prev


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Context manager: inside it the cast sites compute in ``dtype``;
    ``enable=False`` switches amp off inside (also within an outer
    ``auto_cast``)."""
    return amp_state_guard({"enable": enable, "level": level,
                            "dtype": _amp_dtype(dtype)} if enable else None)


amp_guard = auto_cast


def maybe_cast_compute(*tensors):
    """The operands of a product, fp32 ones cast to the amp dtype when
    amp is on; everything else (bf16, ints, non-tensors) as given."""
    st = amp_state()
    if not st or not st["enable"]:
        return tensors
    dt = st["dtype"]
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: cast every fp32 parameter of ``models`` (a module or
    a list of them) to the amp dtype in place. Returns ``models``, or
    ``(models, optimizers)`` when optimizers are given."""
    dt = _amp_dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    for mdl in model_list:
        if isinstance(mdl, torch.nn.Module):
            with torch.no_grad():
                for p in mdl.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers
