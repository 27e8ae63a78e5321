"""Inference API (PyTorch port of ``paddle_tpu.inference``).

Reference: python/paddle/inference (Config, create_predictor, Predictor),
the deployment runtime over a saved program. ``create_llm_predictor``
serves a ``serving.save_lm`` artifact (written by this package or by the
JAX package: the format is shared) through the continuous-batching
``serving.Engine``, on the card unless ``device="cpu"`` is given.
``create_predictor`` and ``PredictorPool`` read ``jit.save`` artifacts;
the port exports no graph yet (port queue item 9), so a ``Predictor``'s
``run`` raises, as the JAX one does on a weights-only artifact.
"""
from __future__ import annotations

import enum

import numpy as np

__all__ = ['Config', 'Predictor', 'create_predictor']


class Config:
    """Reference: paddle/fluid/inference/api/analysis_config.cc surface
    (the knobs that matter here). The device of an LLM predictor is its
    ``device=`` argument (the card by default), not ``enable_use_gpu``."""
    def __init__(self, prog_file=None, params_file=None):
        self._model_path = prog_file
        self._use_gpu = False
        self._threads = 1
        self._enabled = {"memory_optim": True, "ir_optim": True}

    def set_prog_file(self, path):
        self._model_path = path

    def prog_file(self):
        return self._model_path

    def disable_gpu(self):
        self._use_gpu = False

    def enable_use_gpu(self, *a, **k):
        # recorded; create_llm_predictor's device= picks the device
        self._use_gpu = True

    def use_gpu(self):
        return self._use_gpu

    def set_cpu_math_library_num_threads(self, n):
        self._threads = int(n)

    def switch_ir_optim(self, on=True):
        self._enabled["ir_optim"] = bool(on)

    def enable_memory_optim(self, on=True):
        self._enabled["memory_optim"] = bool(on)

    def summary(self):
        return dict(model=self._model_path, **self._enabled)


class _Handle:
    """Input/output handle mimicking ZeroCopyTensor
    (paddle/fluid/inference/api/details/zero_copy_tensor.cc): ``reshape``
    declares the shape, ``copy_from_cpu`` fills data (validated against the
    declared shape), ``copy_to_cpu`` reads back."""

    def __init__(self, name, shape=None):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._value = None

    def reshape(self, shape):
        shape = tuple(int(s) for s in shape)
        if self._value is not None:
            if self._value.size != int(np.prod(shape)):
                # refuse rather than silently keeping the old buffer with
                # a contradicting declared shape
                raise ValueError(
                    f"handle '{self.name}': reshape{shape} changes element "
                    f"count ({self._value.size} -> {int(np.prod(shape))}); "
                    "clear or refill the handle first")
            self._value = self._value.reshape(shape)
        self._shape = shape

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._shape) if self._shape is not None else None

    def copy_from_cpu(self, arr):
        arr = np.asarray(arr)
        if self._shape is not None and arr.shape != self._shape:
            if arr.size == int(np.prod(self._shape)):
                arr = arr.reshape(self._shape)
            else:
                raise ValueError(
                    f"handle '{self.name}' declared shape {self._shape}, "
                    f"got {arr.shape}")
        self._value = arr

    def copy_to_cpu(self):
        return np.asarray(self._value)


class Predictor:
    def __init__(self, config: Config, _shared_layer=None):
        from ..jit.serialization import load as jit_load
        if _shared_layer is not None:
            self._layer = _shared_layer
        else:
            if config.prog_file() is None:
                raise ValueError("Config has no model path")
            path = config.prog_file()
            if path.endswith(".pdmodel"):
                path = path[:-len(".pdmodel")]
            self._layer = jit_load(path)
        # names as the artifact records them (a JAX artifact with a graph
        # names its inputs and outputs); no shapes: the port runs no graph
        in_names = getattr(self._layer, "input_names", None) or ["x0"]
        out_names = getattr(self._layer, "output_names", None) or ["out0"]
        self._inputs = [_Handle(n) for n in in_names]
        self._outputs = [_Handle(n) for n in out_names]

    def get_input_names(self):
        return [h.name for h in self._inputs]

    def get_output_names(self):
        return [h.name for h in self._outputs]

    def get_input_handle(self, name):
        return next(h for h in self._inputs if h.name == name)

    def get_output_handle(self, name):
        return next(h for h in self._outputs if h.name == name)

    def run(self, inputs=None):
        """Either positional arrays or the filled ``copy_from_cpu``
        handles, as in the reference. The port runs no graph: the
        artifact's layer raises (``RuntimeError`` on a weights-only
        artifact, ``NotImplementedError`` on a JAX one with StableHLO)."""
        if inputs is None:
            missing = [h.name for h in self._inputs if h._value is None]
            if missing:
                raise RuntimeError(
                    f"input handles not filled: {missing}")
            inputs = [h._value for h in self._inputs]
        return self._layer(*inputs)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class LLMPredictor:
    """Serving-engine predictor over a saved CausalLM artifact (the
    ``create_predictor`` analog for generative workloads): rebuilds the
    model from the artifact's weights + config on ``device`` (the card
    by default) and serves it through ``serving.Engine``. submit /
    generate_all / drain and the metrics come straight from the engine.

    An artifact recording an AOT geometry (the JAX package's
    ``save_lm(precompile=True)``) raises ``NotImplementedError``: the port
    has no program handles (ROADMAP.md, port queue: runtime services)."""

    def __init__(self, config, n_slots=None, max_len=None, device=None,
                 **engine_kwargs):
        from ..framework.device import resolve_device
        from ..framework.io import load_numpy_state_dict
        from ..jit.serialization import load as jit_load
        from ..serving import Engine
        from ..serving.engine import _not_in_slice

        path = config.prog_file() if isinstance(config, Config) else config
        if path is None:
            raise ValueError("Config has no model path")
        if path.endswith(".pdmodel"):
            path = path[:-len(".pdmodel")]
        layer = jit_load(path)
        cfgs = getattr(layer, "configs", {}) or {}
        if "llm_config" not in cfgs:
            raise ValueError(
                "artifact was not saved with serving.save_lm (no "
                "llm_config recorded); cannot rebuild the model")
        if cfgs.get("aot_geometry"):
            raise _not_in_slice("AOT program handles (a precompiled "
                                "save_lm artifact)", "runtime services")
        device = resolve_device(device)
        arch = cfgs.get("llm_arch", "llama")
        if arch == "llama":
            from ..text.models.llama import LlamaConfig, LlamaForCausalLM
            model = LlamaForCausalLM(LlamaConfig(**cfgs["llm_config"]),
                                     device=device)
        else:
            from ..text.models.gpt import GPTConfig, GPTForCausalLM
            model = GPTForCausalLM(GPTConfig(**cfgs["llm_config"]),
                                   device=device)
        load_numpy_state_dict(model, layer.numpy_state_dict())
        model.eval()
        self.model = model
        self.engine = Engine(model, n_slots=8 if n_slots is None else n_slots,
                             max_len=max_len, **engine_kwargs)

    def submit(self, prompt, **gen_kwargs):
        return self.engine.submit(prompt, **gen_kwargs)

    def generate_all(self, prompts, **gen_kwargs):
        return self.engine.generate_all(prompts, **gen_kwargs)

    def drain(self):
        self.engine.drain()

    def stats(self):
        return self.engine.stats()


def create_llm_predictor(config, n_slots=None, max_len=None, device=None,
                         **engine_kwargs) -> LLMPredictor:
    """Serve a ``serving.save_lm`` artifact through the continuous-batching
    engine. ``config`` is an inference.Config (its prog_file points at the
    artifact) or the artifact path itself; ``device`` defaults to the
    card; ``n_slots`` to 8."""
    return LLMPredictor(config, n_slots=n_slots, max_len=max_len,
                        device=device, **engine_kwargs)


# -- type/query surface (reference paddle/inference/__init__.py wraps
# fluid.inference enums; values mirror the C++ analysis-config enums) --

class DataType(enum.Enum):
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


class PlaceType(enum.Enum):
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    NPU = 3
    CUSTOM = 4


class PrecisionType(enum.Enum):
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


class BackendType(enum.Enum):
    CPU = 0
    GPU = 1
    TENSORRT = 2
    XPU = 3


Tensor = _Handle  # reference exposes the handle type as inference.Tensor


def get_version():
    import paddle_tpu_torch

    return getattr(paddle_tpu_torch, "__version__", "0.0.0-cuda")


def get_trt_compile_version():
    return (0, 0, 0)  # no TensorRT in the port


def get_trt_runtime_version():
    return (0, 0, 0)


def get_num_bytes_of_data_type(dtype):
    sizes = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
             DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
             DataType.BFLOAT16: 2}
    return sizes[dtype]


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision,
                               backend, keep_io_types=True,
                               black_list=None, **kwargs):
    """Mixed precision is a property of the model (``amp`` or bf16
    parameters), not of the artifact: re-save the model in bf16."""
    raise NotImplementedError(
        "convert_to_mixed_precision: re-export the model with bf16 "
        "parameters (layer.to(dtype='bfloat16') + jit.save) instead")


class PredictorPool:
    """A pool of ``size`` predictors sharing one Config, for serving
    threads that each want a private handle set. Reference:
    paddle/fluid/inference/api/paddle_infer_contrib (PredictorPool pybind,
    ``retrive(idx)``). The first predictor loads the artifact; the rest
    clone it (a shared loaded artifact, private handles)."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError("PredictorPool size must be >= 1")
        first = create_predictor(config)
        self._preds = [first] + [
            Predictor(config, _shared_layer=first._layer)
            for _ in range(int(size) - 1)]

    def retrive(self, idx: int) -> Predictor:
        return self._preds[int(idx)]

    retrieve = retrive  # spelling-corrected alias


__all__ += ["DataType", "PlaceType", "PrecisionType", "BackendType",
            "Tensor", "get_version", "get_trt_compile_version",
            "get_trt_runtime_version", "get_num_bytes_of_data_type",
            "convert_to_mixed_precision", "PredictorPool",
            "LLMPredictor", "create_llm_predictor"]
