"""Math ops. Counterpart of ``paddle_tpu/tensor_ops/math.py``.

Elementwise ops broadcast and promote as torch does, which for the
operands below 64 bits is the JAX package's promotion table; a python
scalar promotes as JAX's weak scalar does (``_factory``). Transcendental
ops on integers compute in the default float dtype, as JAX's do. Sums,
products and cumulative sums of integers narrower than 64 bits stay
int32 (torch would widen them to int64; the JAX package keeps int32);
``mean`` of integers is the default float dtype. ``max``/``min`` share a
tie's gradient among the tied elements, as JAX's do.

``matmul`` (and ``mm``, ``bmm``) pass ``amp.maybe_cast_compute`` first,
as in the JAX package, so under ``amp.auto_cast`` an fp32 operand is
cast to the amp dtype and the product comes out in it.
"""
from __future__ import annotations



import torch

from ..amp.auto_cast import maybe_cast_compute
from ..framework import dtype as dtype_mod
from ._factory import (binary, dims, floating, operands, promoted,
                       reduction, stop, tensor, unary)

__all__ = [
    "abs", "acos", "acosh", "add", "addmm", "all", "amax", "amin", "angle",
    "any", "asin", "asinh", "atan", "atan2", "atanh", "bmm",
    "broadcast_shape", "ceil", "clip", "conj", "copysign", "cos", "cosh",
    "count_nonzero", "cross", "cummax", "cummin", "cumprod", "cumsum",
    "deg2rad", "diagonal", "diff", "digamma", "divide", "divide_no_nan",
    "dot", "erf", "erfinv", "exp", "expm1", "floor", "floor_divide",
    "floor_mod", "fmax", "fmin", "frac", "gcd", "heaviside", "hypot", "i0",
    "i1", "increment", "inner", "isfinite", "isinf", "isnan", "kron", "lcm",
    "lerp", "lgamma", "log", "log10", "log1p", "log2", "logaddexp", "logit",
    "logsumexp", "matmul", "max", "maximum", "mean", "min", "minimum", "mm",
    "mod", "multiplex", "multiply", "nan_to_num", "nanmean", "nansum",
    "neg", "nextafter", "outer", "pow", "prod", "rad2deg", "reciprocal",
    "remainder", "renorm", "round", "rsqrt", "scale", "sigmoid", "sign",
    "sin", "sinh", "softplus_raw", "sqrt", "square", "stanh", "subtract",
    "sum", "tan", "tanh", "trace", "true_divide", "trunc",
]


def _f(fn):
    """``fn`` on ``x`` in floating point (integers in the default float)."""
    return lambda x: fn(floating(x))


# -- elementwise unary ---------------------------------------------------
abs = unary(torch.abs, name="abs")
acos = unary(_f(torch.acos), name="acos")
acosh = unary(_f(torch.acosh), name="acosh")
asin = unary(_f(torch.asin), name="asin")
asinh = unary(_f(torch.asinh), name="asinh")
atan = unary(_f(torch.atan), name="atan")
atanh = unary(_f(torch.atanh), name="atanh")
ceil = unary(torch.ceil, name="ceil")
cos = unary(_f(torch.cos), name="cos")
cosh = unary(_f(torch.cosh), name="cosh")
digamma = unary(_f(torch.digamma), name="digamma")
erf = unary(_f(torch.erf), name="erf")
erfinv = unary(_f(torch.erfinv), name="erfinv")
exp = unary(_f(torch.exp), name="exp")
expm1 = unary(_f(torch.expm1), name="expm1")
floor = unary(torch.floor, name="floor")
lgamma = unary(_f(torch.lgamma), name="lgamma")
log = unary(_f(torch.log), name="log")
log10 = unary(_f(torch.log10), name="log10")
log1p = unary(_f(torch.log1p), name="log1p")
log2 = unary(_f(torch.log2), name="log2")
neg = unary(torch.neg, name="neg")
reciprocal = unary(_f(torch.reciprocal), name="reciprocal")
round = unary(torch.round, name="round")
rsqrt = unary(_f(torch.rsqrt), name="rsqrt")
sigmoid = unary(_f(torch.sigmoid), name="sigmoid")
sign = unary(torch.sign, name="sign")
sin = unary(_f(torch.sin), name="sin")
sinh = unary(_f(torch.sinh), name="sinh")
sqrt = unary(_f(torch.sqrt), name="sqrt")
square = unary(torch.square, name="square")
tan = unary(_f(torch.tan), name="tan")
tanh = unary(_f(torch.tanh), name="tanh")
trunc = unary(torch.trunc, name="trunc")
angle = unary(_f(torch.angle), name="angle")
conj = unary(torch.conj_physical, name="conj")
deg2rad = unary(_f(torch.deg2rad), name="deg2rad")
rad2deg = unary(_f(torch.rad2deg), name="rad2deg")
frac = unary(lambda x: x - torch.trunc(x), name="frac")
i0 = unary(_f(torch.special.i0), name="i0")
i1 = unary(_f(torch.special.i1), name="i1")

isfinite = unary(torch.isfinite, differentiable=False, name="isfinite")
isinf = unary(torch.isinf, differentiable=False, name="isinf")
isnan = unary(torch.isnan, differentiable=False, name="isnan")


# -- elementwise binary --------------------------------------------------
def _hypot(a, b):
    # the JAX package's formula (also its gradient), not torch.hypot
    return torch.sqrt(a * a + b * b)


def _on_floats(fn):
    return lambda a, b: fn(*promoted(floating(a), floating(b)))


add = binary(torch.add, name="add")
subtract = binary(torch.sub, name="subtract")
multiply = binary(torch.mul, name="multiply")
divide = binary(torch.true_divide, name="divide")
true_divide = divide
floor_divide = binary(torch.floor_divide, differentiable=False,
                      name="floor_divide")
mod = binary(torch.remainder, name="mod")
remainder = mod
floor_mod = mod
pow = binary(torch.pow, name="pow")
maximum = binary(torch.maximum, name="maximum")
minimum = binary(torch.minimum, name="minimum")
fmax = binary(torch.fmax, name="fmax")
fmin = binary(torch.fmin, name="fmin")
atan2 = binary(_on_floats(torch.atan2), name="atan2")
heaviside = binary(lambda a, b: torch.heaviside(*promoted(a, b)),
                   name="heaviside")
hypot = binary(_hypot, name="hypot")
logaddexp = binary(_on_floats(torch.logaddexp), name="logaddexp")
nextafter = binary(lambda a, b: torch.nextafter(*promoted(a, b)),
                   differentiable=False, name="nextafter")
gcd = binary(torch.gcd, differentiable=False, name="gcd")
lcm = binary(torch.lcm, differentiable=False, name="lcm")
copysign = binary(_on_floats(torch.copysign), name="copysign")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = tensor(x)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def divide_no_nan(x, y, name=None):
    a, b = operands(x, y)
    zero = b == 0
    return torch.where(zero, 0.0, a / torch.where(zero, torch.ones_like(b), b))


def multiplex(inputs, index, name=None):
    stacked = torch.stack(operands(*inputs), dim=0)
    idx = tensor(index, stacked.device).reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


# -- matmul family -------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each optionally with its last two dims swapped."""
    a, b = maybe_cast_compute(*operands(x, y))
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


mm = matmul


def bmm(x, y, name=None):
    return torch.matmul(*maybe_cast_compute(*operands(x, y)))


def dot(x, y, name=None):
    a, b = operands(x, y)
    return torch.sum(a * b, dim=-1)


def inner(x, y, name=None):
    return torch.inner(*operands(x, y))


def outer(x, y, name=None):
    a, b = operands(x, y)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = operands(input, x, y)
    return beta * i + alpha * torch.matmul(a, b)


def kron(x, y, name=None):
    return torch.kron(*operands(x, y))


def cross(x, y, axis=9, name=None):
    """The cross product over ``axis`` (by default the first dim of size
    3)."""
    a, b = operands(x, y)
    if axis == 9:
        axis = next(i for i, d in enumerate(a.shape) if d == 3)
    return torch.linalg.cross(a, b, dim=axis)


# -- reductions ----------------------------------------------------------
def _int_acc(x):
    """The dtype integer sums and products keep: int32 below 64 bits (the
    JAX package's), int64 at 64."""
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.int64:
        return None
    return torch.int32


def _sum(x, d, keepdim):
    return torch.sum(x, d, keepdim=keepdim, dtype=_int_acc(x))


def _prod(x, d, keepdim):
    dt = _int_acc(x)
    if dt is not None:
        x = x.to(dt)
    for ax in sorted(d, reverse=True):
        x = torch.prod(x, ax, keepdim=keepdim, dtype=dt)
    return x


def _mean(x, d, keepdim):
    return torch.mean(floating(x), d, keepdim=keepdim)


def _logical(fn):
    return lambda x, d, keepdim: fn(x.bool() if x.dtype != torch.bool else x,
                                    dim=d, keepdim=keepdim)


sum = reduction(_sum, dtype_slot="before_keepdim", name="sum")
mean = reduction(_mean, name="mean")
prod = reduction(_prod, dtype_slot="after_keepdim", name="prod")
max = reduction(lambda x, d, k: torch.amax(x, d, keepdim=k), name="max")
min = reduction(lambda x, d, k: torch.amin(x, d, keepdim=k), name="min")
amax = reduction(lambda x, d, k: torch.amax(x, d, keepdim=k), name="amax")
amin = reduction(lambda x, d, k: torch.amin(x, d, keepdim=k), name="amin")
logsumexp = reduction(
    lambda x, d, k: torch.logsumexp(floating(x), d, keepdim=k),
    name="logsumexp")
all = reduction(_logical(torch.all), name="all")
any = reduction(_logical(torch.any), name="any")
nansum = reduction(lambda x, d, k: torch.nansum(x, d, keepdim=k),
                   dtype_slot="before_keepdim", name="nansum")


def nanmean(x, axis=None, keepdim=False, name=None):
    x = tensor(x)
    return torch.nanmean(floating(x), dims(axis, x.dim()), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = tensor(x)
    return stop(torch.sum(x != 0, dims(axis, x.dim()), keepdim=keepdim))


# -- cumulative ----------------------------------------------------------
def _cum(fn, x, axis, dtype):
    x = tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    dt = dtype_mod.convert_dtype(dtype) or _int_acc(x)
    return fn(x, axis, dtype=dt)


def cumsum(x, axis=None, dtype=None, name=None):
    return _cum(torch.cumsum, x, axis, dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    return _cum(torch.cumprod, x, dim, dtype)


def _cum_extreme(x, axis, dtype, running):
    """(values, indices) of a running max/min; a tie keeps the earlier
    index (the paddle contract the JAX package keeps)."""
    x = tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = running(x, axis).values
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    prev = vals.narrow(axis, 0, x.shape[axis] - 1)
    changed = torch.cat([torch.ones_like(vals.narrow(axis, 0, 1),
                                         dtype=torch.bool),
                         vals.narrow(axis, 1, x.shape[axis] - 1) != prev],
                        dim=axis)
    idx = torch.cummax(torch.where(changed, pos, 0).expand_as(x),
                       axis).values
    idx = idx.to(dtype_mod.convert_dtype(dtype))
    return torch.gather(x, axis, idx.long()), stop(idx)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummin)


# -- clip / misc ---------------------------------------------------------
_CLIP_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
                torch.int32, torch.int64)


def clip(x, min=None, max=None, name=None):
    x = tensor(x)
    if x.dtype not in _CLIP_DTYPES:
        raise TypeError(f"clip: x of dtype {x.dtype} is not supported")
    lo = tensor(min, x.device).to(x.dtype) if min is not None else None
    hi = tensor(max, x.device).to(x.dtype) if max is not None else None
    if lo is not None:
        x = torch.maximum(x, lo)
    if hi is not None:
        x = torch.minimum(x, hi)
    return x


def lerp(x, y, weight, name=None):
    a, b, w = operands(x, y, weight)
    return a + w * (b - a)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(tensor(x), nan=nan, posinf=posinf,
                            neginf=neginf)


def logit(x, eps=None, name=None):
    a = floating(tensor(x))
    if eps is not None:
        a = torch.clamp(a, eps, 1.0 - eps)
    return torch.log(a / (1.0 - a))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2).clone()


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = tensor(x)
    p = tensor(prepend, x.device) if prepend is not None else None
    a = tensor(append, x.device) if append is not None else None
    return torch.diff(x, n, axis, prepend=p, append=a)


def increment(x, value=1.0, name=None):
    """``x += value`` in place, outside the autograd graph."""
    with torch.no_grad():
        x.add_(value)
    return x


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * floating(tensor(x)))


def softplus_raw(x):
    x = floating(tensor(x))
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def renorm(x, p, axis, max_norm, name=None):
    a = tensor(x)
    d = [i for i in range(a.dim()) if i != axis % a.dim()]
    norms = torch.sum(torch.abs(a) ** p, d, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return a * factor
