"""``save`` / ``load`` (paddle.save / paddle.load), and the weight carry
between the JAX package and the port.

``save(obj, path)`` writes ``obj`` (nested dicts and lists of tensors,
arrays and python values: a ``state_dict``, an optimizer's) in the JAX
package's ``framework/io.save`` layout with the checkpoint writer
(``distributed.checkpoint._write_state``): one pickle with numpy leaves,
published atomically, bfloat16 widened to float32 (exactly) and listed
in ``<path>.dtypes.json``. So a ``.pdparams`` / ``.pdopt`` the port
writes loads in the JAX package's ``paddle.load`` / ``Model.load``, and
``load(path)`` reads what either package wrote (JAX's tensor records
and bfloat16 arrays included) as tensors on ``device`` (the framework's
default, ``cuda``, unless given), bfloat16 where the record says so.

``load_numpy_state_dict(model, arrays)`` fills a port module from numpy
arrays keyed like the JAX package's ``state_dict`` — for example
``{k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}`` —
so both packages then compute the same function. Layouts are shared
(``Linear.weight`` is ``[in, out]`` on both sides): no transposes. Any
key the two modules share carries: quantized models' int8 ``qweight``
(copied as int8, never through a float), their 0-d ``act_scale``, and
QAT's ``*.inner.weight`` and ``*.act_fake_quant.{scale,initialized}``.

On a model placed by ``fleet.distributed_model`` the arrays are still the
full ones: each rank takes its block of every array by the parameter's
placement (its tp slice, its pp chunk of a stacked ``[L, ...]`` array,
its stage-3 shard; a parameter with a ``column_order``, such as GPT's
fused qkv under tp, its block of the columns in that order), and
``gather_state_dict`` gives every rank the full arrays back (the chunks
all-gathered over pp, the columns back in the JAX layout).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_state_dict", "load", "load_numpy_state_dict", "save"]


def save(obj, path, protocol=5, **configs):
    """Write ``obj`` to ``path`` (see the module docstring; the pickle is
    protocol 5 whatever ``protocol`` says)."""
    from ..distributed.checkpoint import _to_host, _write_state
    dtypes = {}
    _write_state(_to_host(obj, dtypes=dtypes), dtypes, str(path))


def load(path, device=None, **configs):
    """Read what ``save`` (or the JAX package's ``paddle.save``) wrote:
    every array a tensor on ``device``."""
    from ..distributed.checkpoint import _read_state, _typed
    from .device import resolve_device
    tree, dtypes = _read_state(str(path))
    return _typed(tree, dtypes, resolve_device(device))


def load_numpy_state_dict(model: torch.nn.Module, arrays: dict) -> None:
    """Copy ``arrays`` (name -> np.ndarray) into ``model``'s parameters
    and buffers in place, casting to each parameter's dtype and device.

    Raises KeyError when the key sets differ and ValueError on a shape
    mismatch; nothing is written unless every key and shape matches.
    """
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    for k, t in own.items():
        shape = tuple(np.shape(arrays[k]))
        want = tuple(getattr(t, "full_shape", t.shape))
        if shape != want:
            raise ValueError(f"{k}: shape {shape} does not match the "
                             f"model's {want}")
    with torch.no_grad():
        for k, t in own.items():
            a = arrays[k]
            spec = getattr(t, "placement", None)
            if spec is not None and any(spec):
                from ..distributed.mesh import local_block
                order = getattr(t, "column_order", None)
                if order is not None:
                    a = np.asarray(a)[..., order]
                a = local_block(a, spec)
            # bfloat16 (an ml_dtypes array: numpy has none) goes via
            # float32, exactly; every other dtype, int8 included, as it is
            a = np.asarray(a)
            if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
            t.copy_(torch.from_numpy(np.array(a, copy=True)).to(t.dtype))


def gather_state_dict(model: torch.nn.Module) -> dict:
    """The model's full state as numpy arrays (name -> np.ndarray, in the
    parameters' dtypes; bfloat16 as float32): each placed parameter is
    all-gathered over the mesh axes its placement shards. Every rank of
    the mesh calls it and gets the whole."""
    out = {}
    with torch.no_grad():
        for k, t in model.state_dict(keep_vars=True).items():
            spec = getattr(t, "placement", None)
            order = getattr(t, "column_order", None)
            t = t.detach()
            if spec is not None and any(spec):
                from ..distributed.mesh import gather_full
                t = gather_full(t, spec)
                if order is not None:
                    t = t[..., torch.from_numpy(np.argsort(order)).to(
                        t.device)]
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[k] = t.cpu().numpy().copy()
    return out
