"""Paddle dtype names -> torch dtypes.

Counterpart of ``paddle_tpu/framework/dtype.py``: the same string names
("bfloat16", "float32", "int32", ...) resolve to torch dtypes, so model
configs written for the JAX package (``LlamaConfig.dtype``) drive the
port unchanged. numpy dtypes and scalar types resolve by their names.

``set_default_dtype`` / ``get_default_dtype`` hold the floating dtype
that ``to_tensor`` gives a float64 numpy array (or a python float) when
no dtype is asked for, and that the creation and random ops use by
default. The port keeps a 64-bit dtype only where the caller asks for
one (the JAX package, with x64 off, turns every 64-bit operand into its
32-bit twin); integer index results (``argmax``, ``nonzero``, ...) are
int64, torch's index dtype.
"""
from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "float": torch.float32,
    "double": torch.float64,
    "half": torch.float16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int": torch.int32,
    "uint8": torch.uint8,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def convert_dtype(dtype) -> torch.dtype | None:
    """A paddle dtype name, a numpy dtype (or scalar type) or a torch
    dtype as a torch dtype; None stays None ("keep as is")."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        try:
            dtype = np.dtype(dtype).name
        except TypeError:
            raise ValueError(f"Unknown dtype: {dtype!r}") from None
    try:
        return _STR2DTYPE[dtype]
    except KeyError:
        raise ValueError(f"Unknown dtype: {dtype!r}") from None


def dtype_name(dtype) -> str:
    """The paddle name of a torch dtype ("float32", "int64", ...)."""
    return str(convert_dtype(dtype)).replace("torch.", "")


_default_dtype = torch.float32


def set_default_dtype(dtype) -> None:
    """Set the default floating dtype; raises TypeError for any other."""
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating point, got {d}")
    _default_dtype = d


def get_default_dtype() -> str:
    """The default floating dtype's name ("float32" unless set)."""
    return dtype_name(_default_dtype)


def default_dtype() -> torch.dtype:
    """The default floating dtype as a torch dtype."""
    return _default_dtype
