"""jit.save / jit.load. Counterpart of ``paddle_tpu/jit/serialization.py``
(reference: python/paddle/jit/api.py save/load).

The artifact is the JAX package's, on purpose: one pickle at
``<path>.pdmodel`` holding ``{"format": "paddle_tpu.jit", "version": 1,
"configs": ..., "state_dict": {name: numpy array}, "class": ...,
"stablehlo": ...}``, so a weights artifact written by either package is
read by the other (``serving.save_lm`` -> ``inference.create_llm_predictor``
across packages).

What the port writes and reads:

- bf16 tensors are written as float32 arrays (exact), because numpy has
  no bfloat16 without ``ml_dtypes``, which the CUDA machines need not
  have. The artifact's ``state_dtypes`` ({name: "bfloat16"}) records
  them, and ``TranslatedLayer.state_dict()`` casts them back, so a bf16
  round trip is bit for bit.
- A JAX-written bf16 artifact holds ``ml_dtypes.bfloat16`` arrays: it
  loads only where ``ml_dtypes`` imports, and raises an error naming it
  elsewhere.
- The pickle is read by a restricted unpickler that admits numpy's array
  and dtype constructors and a few builtins only (``ml_dtypes`` dtypes
  where it imports): nothing else is imported or called.
- A graph: the JAX package exports StableHLO for ``input_spec=``; the
  port's counterpart is ``torch.export``, which needs the hand-written
  kernels registered as ``torch.library`` ops first (ROADMAP.md, port
  queue item 9). So ``save(..., input_spec=...)`` raises, and a JAX
  artifact carrying StableHLO loads for its weights and configs but
  raises when called.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "TranslatedLayer"]

_GRAPH_TODO = ("a graph-carrying jit artifact (torch.export of the model, "
               "its hand-written kernels registered as torch.library ops) "
               "is not in the port yet (ROADMAP.md, port queue item 9: "
               "long tail)")


def save(layer, path, input_spec=None, **configs):
    """Write ``layer``'s weights (and ``configs``) to ``<path>.pdmodel``;
    returns that path. ``input_spec`` asks for a graph, which the port
    does not export yet: it raises ``NotImplementedError``."""
    if input_spec is not None:
        raise NotImplementedError(_GRAPH_TODO)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": "paddle_tpu.jit", "version": 1}
    if configs:
        payload["configs"] = dict(configs)
    if isinstance(layer, torch.nn.Module):
        arrays, dtypes = {}, {}
        with torch.no_grad():
            for k, v in layer.state_dict().items():
                t = v.detach()
                if t.dtype == torch.bfloat16:
                    dtypes[k] = "bfloat16"
                    t = t.float()
                arrays[k] = t.cpu().numpy().copy()
        payload["state_dict"] = arrays
        if dtypes:
            payload["state_dtypes"] = dtypes
        payload["class"] = (type(layer).__module__ + "."
                            + type(layer).__qualname__)
    payload["stablehlo"] = None
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(payload, f)
    return path + ".pdmodel"


_NUMPY_NAMES = {"dtype", "ndarray", "_reconstruct", "scalar", "_frombuffer"}
_BUILTIN_NAMES = {"bytearray", "bytes", "set", "frozenset", "complex",
                  "slice", "range"}


class _ArtifactUnpickler(pickle.Unpickler):
    """Admits numpy arrays and dtypes, a few builtin containers and
    ``ml_dtypes`` dtypes (where it imports); refuses every other
    global."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module in ("builtins", "__builtin__") and name in _BUILTIN_NAMES:
            return super().find_class(module, name)
        if (module, name) == ("_codecs", "encode"):      # protocol 2 bytes
            return super().find_class(module, name)
        if top == "ml_dtypes":
            try:
                import ml_dtypes
            except ImportError as e:
                raise RuntimeError(
                    f"the artifact holds {module}.{name} arrays (a bf16 "
                    "artifact written by the JAX package); reading them "
                    "needs the ml_dtypes package, which is not "
                    "installed") from e
            return getattr(ml_dtypes, name)
        raise pickle.UnpicklingError(
            f"jit.load: the artifact refers to {module}.{name}, which a "
            "paddle_tpu.jit artifact never holds")


def _to_tensor(a, dtype_name=None):
    """An artifact array as a CPU tensor: ml_dtypes bf16 via float32
    (exact), float32 back to bf16 where ``state_dtypes`` says so."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype_name is not None:
        t = t.to(getattr(torch, dtype_name))
    return t


class TranslatedLayer:
    """An artifact loaded back: ``configs``, ``state_dict()`` and, where
    the artifact carried a graph, the graph's names. Calling it raises:
    the port runs no graph yet."""

    def __init__(self, payload):
        self._payload = payload
        self.input_names = payload.get("input_names")
        self.output_names = payload.get("output_names")
        self.configs = payload.get("configs", {})
        # a StableHLO graph (a JAX artifact) is kept, never run
        self.has_graph = bool(payload.get("stablehlo"))

    def state_dict(self):
        """{name: CPU tensor}, each in the dtype it was saved from."""
        dtypes = self._payload.get("state_dtypes", {})
        return {k: _to_tensor(v, dtypes.get(k))
                for k, v in self._payload.get("state_dict", {}).items()}

    def numpy_state_dict(self):
        """{name: numpy array} as stored (bf16 as float32 or as an
        ml_dtypes array): what ``framework.io.load_numpy_state_dict``
        takes, casting to each parameter's dtype."""
        return dict(self._payload.get("state_dict", {}))

    def __call__(self, *args):
        if self.has_graph:
            raise NotImplementedError(
                "this artifact carries a StableHLO graph, which the port "
                "does not run: " + _GRAPH_TODO)
        raise RuntimeError(
            "artifact has no compiled graph; re-save with input_spec or "
            "rebuild the Layer class and use set_state_dict")


def load(path, **configs):
    p = path if path.endswith(".pdmodel") else path + ".pdmodel"
    with open(p, "rb") as f:
        payload = _ArtifactUnpickler(f).load()
    if not isinstance(payload, dict) \
            or payload.get("format") != "paddle_tpu.jit":
        raise ValueError(f"{p} is not a paddle_tpu.jit artifact")
    return TranslatedLayer(payload)
