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
"""
from .framework.device import get_device, set_device
from .framework.io import load, save
from .framework.random_seed import seed
from .hapi import Model, flops, summary

__all__ = ["Model", "flops", "get_device", "load", "save", "set_device",
           "seed", "summary"]
