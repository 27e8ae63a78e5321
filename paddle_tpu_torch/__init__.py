"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors ``paddle_tpu``'s module paths (``framework/``,
``nn/``, ``ops/``, ``optimizer/``, ``distributed/``, ``text/``,
``serving/``) with PyTorch idiom inside:
``nn.Module``s, an explicit ``device`` argument and explicit
``torch.Generator``s for initialisation. Parameter names and layouts stay
the JAX package's (``Linear.weight`` is ``[in, out]``), so a state dict
carries across through numpy (``framework.io.load_numpy_state_dict``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a machine without it raises. Serving goes through
``serving.Engine``, training through ``distributed.fleet`` and
``optimizer``, or through the high-level ``Model`` (``hapi``: fit,
evaluate, predict, save, load, with ``metric`` and ``callbacks``). The TPU kernels on those paths are hand-written CUDA C++
for Hopper under ``csrc/``, built at first use (``ops/_build.py``); on a
CPU tensor each wrapper runs the kernel's plain PyTorch version instead.

The eager surface is JAX's top level: ``to_tensor`` (a ``torch.Tensor``
on the framework's device; ``place="cpu"`` or ``set_device("cpu")`` for
the CPU), the flat op namespace (``paddle.concat``, ``paddle.matmul``,
...: ``tensor_ops``), the dtype names, the grad modes, ``grad`` (the
functional transform, ``autograd.functional.grad``), ``autograd``
(``PyLayer``, ``jacobian``, ...), ``linalg`` and ``nn.Layer`` with
``ParamAttr``. ``Tensor`` is ``torch.Tensor``, whose methods stay
torch's: paddle's tensor methods are not attached.
"""
import sys as _sys

from . import autograd, observability  # noqa: F401
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .framework.device import get_device, set_device
from .framework.dtype import (bfloat16, bool_, complex64, complex128,
                              float16, float32, float64, get_default_dtype,
                              int8, int16, int32, int64, set_default_dtype,
                              uint8)
from .framework.io import load, save
from .framework.random_seed import seed
from .hapi import Model, flops, summary
from .nn.layer_base import ParamAttr
from .tensor import Parameter, Tensor, is_tensor, to_tensor
from .tensor_ops import *  # noqa: F401,F403
from .tensor_ops import __all__ as _ops
from .tensor_ops import linalg
from .tensor_ops.creation import _memcpy  # noqa: F401

# ``import paddle_tpu_torch.linalg`` works, as paddle's real submodule
_sys.modules[__name__ + ".linalg"] = linalg

bool = bool_  # noqa: A001  (paddle.bool)

__all__ = sorted(_ops + [
    "Model", "ParamAttr", "Parameter", "Tensor", "autograd", "bfloat16",
    "bool", "bool_", "complex64", "complex128", "enable_grad", "float16",
    "float32", "float64", "flops", "get_default_dtype", "get_device", "grad",
    "int8", "int16", "int32", "int64", "is_grad_enabled", "is_tensor",
    "linalg", "load", "no_grad", "save", "seed", "set_default_dtype",
    "set_device", "set_grad_enabled", "summary", "to_tensor", "uint8"])
