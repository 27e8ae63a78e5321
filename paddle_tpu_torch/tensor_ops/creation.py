"""Creation ops. Counterpart of ``paddle_tpu/tensor_ops/creation.py``.

Ops without a tensor input create on the framework's device (CUDA unless
``set_device`` says otherwise); the ``*_like`` ops on their input's.
A float fill, range or space is the default dtype unless one is asked
for; an integer ``arange`` is int64, as paddle's is.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ..framework.device import resolve_device
from ._factory import as_int, int_list, operands, tensor

__all__ = [
    "arange", "as_complex", "as_real", "assign", "clone", "complex", "diag",
    "diag_embed", "diagflat", "empty", "empty_like", "eye", "full",
    "full_like", "imag", "linspace", "logspace", "meshgrid", "ones",
    "ones_like", "polar", "real", "tril", "tril_indices", "triu",
    "triu_indices", "zeros", "zeros_like",
]

_FULL_DTYPES = ("bool", "float16", "bfloat16", "float32", "float64",
                "uint8", "int16", "int32", "int64", "complex64",
                "complex128")
_LIKE_DTYPES = ("bool", "float16", "bfloat16", "float32", "float64",
                "int16", "int32", "int64")


def _dt(dtype, allowed=None, op=None):
    """``dtype`` as a torch dtype (the default float dtype for None);
    TypeError for a dtype the reference refuses in ``op``."""
    try:
        d = dtype_mod.convert_dtype(dtype)
    except ValueError as e:
        raise TypeError(str(e)) from e
    if d is None:
        return dtype_mod.default_dtype()
    if allowed is not None and dtype_mod.dtype_name(d) not in allowed:
        raise TypeError(f"{op}: dtype {dtype_mod.dtype_name(d)} is not one "
                        f"of {list(allowed)}")
    return d


def _shape(shape):
    dims = tuple(int_list(shape))
    if any(d < 0 for d in dims):
        raise ValueError(
            f"Each dimension of shape is expected to be no less than 0, "
            f"but got {list(dims)}")
    return dims


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(None))


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(None))


def full(shape, fill_value, dtype=None, name=None):
    """A float fill is the default dtype, an int fill int64, a bool fill
    bool, unless ``dtype`` says otherwise."""
    if isinstance(fill_value, str):
        fill_value = float(fill_value)      # the reference takes "0.5"
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.reshape(()).item()
    dt = (_dt(dtype, _FULL_DTYPES, "full") if dtype is not None
          else tensor(fill_value, torch.device("cpu")).dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=resolve_device(None))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like_dt(x, dtype, op):
    return x.dtype if dtype is None else _dt(dtype, _LIKE_DTYPES, op)


def zeros_like(x, dtype=None, name=None):
    x = tensor(x)
    return torch.zeros_like(x, dtype=_like_dt(x, dtype, "zeros_like"))


def ones_like(x, dtype=None, name=None):
    x = tensor(x)
    return torch.ones_like(x, dtype=_like_dt(x, dtype, "ones_like"))


def full_like(x, fill_value, dtype=None, name=None):
    x = tensor(x)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.reshape(()).item()
    return torch.full_like(x, fill_value,
                           dtype=_like_dt(x, dtype, "full_like"))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    """A python scalar, or the value of a 1-element tensor."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).item()
    return v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    dt = dtype_mod.convert_dtype(dtype)
    if dt is None:
        dt = (dtype_mod.default_dtype()
              if any(isinstance(v, float) for v in (start, end, step))
              else torch.int64)
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_device(None))


def linspace(start, stop, num, dtype=None, name=None):
    if isinstance(dtype, str) and dtype not in ("float32", "float64",
                                                "int32", "int64"):
        raise TypeError(f"linspace: dtype {dtype!r} not supported")
    return torch.linspace(_scalar(start), _scalar(stop), as_int(num),
                          dtype=_dt(dtype), device=resolve_device(None))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), as_int(num),
                          base=base, dtype=_dt(dtype),
                          device=resolve_device(None))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = as_int(num_rows)
    m = n if num_columns is None else as_int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=resolve_device(None))


def meshgrid(*args, **kwargs):
    ins = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
           else args)
    return list(torch.meshgrid(*operands(*ins), indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``), or a 2-D ``x``'s ``offset`` diagonal."""
    x = tensor(x)
    out = torch.diag(x, offset)
    if padding_value != 0 and x.dim() == 1:
        mask = torch.ones(out.shape, dtype=torch.bool,
                          device=x.device).diag(offset).diag(offset)
        out = torch.where(mask, out, torch.tensor(
            padding_value, dtype=out.dtype, device=out.device))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(tensor(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(tensor(x), offset, dim1, dim2)


def tril(x, diagonal=0, name=None):
    return torch.tril(tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(tensor(x), diagonal)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset, dtype=_dt(dtype),
                              device=resolve_device(None))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=_dt(dtype), device=resolve_device(None))


def assign(x, output=None):
    """A copy of ``x``; with ``output``, ``x`` copied into it in place."""
    if output is not None:
        with torch.no_grad():
            output.copy_(tensor(x, output.device))
        return output
    return tensor(x).clone()


def clone(x, name=None):
    return tensor(x).clone()


def complex(real, imag, name=None):
    r, i = operands(real, imag)
    return torch.complex(r, i)


def as_complex(x, name=None):
    x = tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = tensor(x)
    return torch.stack([x.real, x.imag], dim=-1)


def real(x, name=None):
    x = tensor(x)
    return x.real.clone() if x.is_complex() else x.clone()


def imag(x, name=None):
    x = tensor(x)
    return x.imag.clone() if x.is_complex() else torch.zeros_like(x)


def polar(abs, angle, name=None):
    r, t = operands(abs, angle)
    return torch.polar(r, t)


def _memcpy(input, place=None, output=None):
    """A copy of ``input`` on ``place`` (the reference's
    tensor/creation.py:_memcpy); with ``output``, copied into it."""
    src = tensor(input)
    if output is not None:
        with torch.no_grad():
            output.copy_(src)
        return output
    return src.to(resolve_device(place) if place is not None
                  else src.device, copy=True)
