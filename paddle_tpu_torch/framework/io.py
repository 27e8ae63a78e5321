"""Weight carry between the JAX package and the port.

``load_numpy_state_dict(model, arrays)`` fills a port module from numpy
arrays keyed like the JAX package's ``state_dict`` — for example
``{k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}`` —
so both packages then compute the same function. Layouts are shared
(``Linear.weight`` is ``[in, out]`` on both sides): no transposes. Any
key the two modules share carries: quantized models' int8 ``qweight``
(copied as int8, never through a float), their 0-d ``act_scale``, and
QAT's ``*.inner.weight`` and ``*.act_fake_quant.{scale,initialized}``.
"""
from __future__ import annotations

import numpy as np
import torch


def load_numpy_state_dict(model: torch.nn.Module, arrays: dict) -> None:
    """Copy ``arrays`` (name -> np.ndarray) into ``model``'s parameters
    and buffers in place, casting to each parameter's dtype and device.

    Raises KeyError when the key sets differ and ValueError on a shape
    mismatch; nothing is written unless every key and shape matches.
    """
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    for k, t in own.items():
        shape = tuple(np.shape(arrays[k]))
        if shape != tuple(t.shape):
            raise ValueError(f"{k}: shape {shape} does not match the "
                             f"model's {tuple(t.shape)}")
    with torch.no_grad():
        for k, t in own.items():
            # bfloat16 (an ml_dtypes array: numpy has none) goes via
            # float32, exactly; every other dtype, int8 included, as it is
            a = np.asarray(arrays[k])
            if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
            t.copy_(torch.from_numpy(np.array(a, copy=True)).to(t.dtype))
