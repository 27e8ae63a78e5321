"""The port's flat op namespace and ``nn.functional``'s activations against
the JAX package's.

The op sweep runs every row of ``chip_smoke.op_cases`` (the table phase
26a also runs on the card) at ``OP_ROWS_CPU`` rows: the same seeded numpy
inputs go to ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>`` (on the
CPU), and the outputs must agree within the row's tolerance
(``chip_smoke.OP_TOL``: integer, bool and index results bit for bit,
elementwise floats 2e-6, reductions 1e-5, linalg 1e-4 of the largest
element, by reconstruction where a factor's sign is free, random ops by
shape and dtype), with the dtypes equal once JAX's 64 -> 32 canonicalisation is applied to the
port's (the port keeps int64 and float64 where they were asked for;
JAX's x64 is off). Differentiable rows also hold the gradient of
``sum(op(x) * w)`` through the JAX package's eager tape against torch's
(``chip_smoke.GRAD_TOL``, 1e-5 of the largest element, times the
square root of the terms a broadcast input's gradient sums). Beside the
table: ``test_op_parity_sweep.py``'s unary shapes and reduction axes,
its promotion matrix, ``to_tensor``'s rules, no silent CPU fallback, and
the coverage of the JAX package's public names.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import autograd as jax_autograd
from paddle_tpu import nn as jax_nn
from paddle_tpu import tensor_ops as jax_ops
from paddle_tpu.nn.functional import activation as jax_activation
from paddle_tpu.tensor import Tensor as JTensor

CASES = cs.op_cases(cs.OP_ROWS_CPU)
ROWS = cs.OP_ROWS_CPU

# the JAX package returns numpy's value-dependent dtype (real eigenvalues
# come back real); the port returns complex, as paddle does
DTYPE_DIVERGENCES = {"eig", "eigvals"}
# JAX's softplus_raw takes a raw jax array, not a Tensor
RAW_JAX = {"softplus_raw"}


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    """The port's default device on the CPU, torch on one thread (the tiny
    ops run far faster than spread over eight)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


def jax_op(case, args, grad):
    """A table row through the JAX package: (outputs as numpy, dtype
    names, the gradient through the eager tape or None, the terms each
    gradient element sums)."""
    F = paddle.nn.functional
    fn = (getattr(F, case.name[2:]) if case.name.startswith("F.")
          else getattr(paddle, case.name))
    slot = cs.grad_slot(args) if grad else None
    leaf = []

    def mark(a):
        t = paddle.to_tensor(a, stop_gradient=False)
        leaf.append(t)
        return t

    if case.name in RAW_JAX:
        out = JTensor(fn(*(a if not isinstance(a, np.ndarray)
                           else paddle.to_tensor(a)._data for a in args),
                         **case.kw))
    else:
        out = fn(*cs.convert_args(args, paddle.to_tensor, slot, mark),
                 **case.kw)
    outs = cs.flat_outputs(out)
    g, terms = None, 1
    if slot is not None:
        y = next(o for o in outs if isinstance(o, JTensor)
                 and np.dtype(o.dtype).kind == "f")
        w = paddle.to_tensor(cs.weights_for(tuple(y.shape)))
        paddle.sum(y * w).backward()
        g = np.asarray(leaf[0].grad.numpy()).astype(np.float32)
        terms = max(1, y.size // max(1, leaf[0].size))
    arrays, dtypes = [], []
    for o in outs:
        if isinstance(o, JTensor):
            a = np.asarray(o._data)
            dtypes.append(str(a.dtype))
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
        else:
            dtypes.append(type(o).__name__)
            a = np.asarray(o)
        arrays.append(a)
    return arrays, dtypes, g, terms


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for case in CASES:
        out[case.id] = jax_op(case, cs.op_args(case, ROWS), case.grad)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case, jax_results):
    args = cs.op_args(case, ROWS)
    want = jax_results[case.id]
    got = cs.port_op(pt, case, args, "cpu", grad=case.grad)
    if case.name not in DTYPE_DIVERGENCES:
        assert [cs._map64(d) for d in got[1]] == want[1]
    assert cs.compare_op(case, args, got[0], want[0]) is None, \
        cs.compare_op(case, args, got[0], want[0])
    assert cs.compare_grad(case, got[2], want[2], want[3]) is None, \
        cs.compare_grad(case, got[2], want[2], want[3])


# -- test_op_parity_sweep.py's unary shapes and reduction axes -------------
UNARY = ["abs", "exp", "log", "log1p", "log2", "log10", "sqrt", "rsqrt",
         "sin", "cos", "tan", "tanh", "sinh", "cosh", "asin", "acos", "atan",
         "asinh", "atanh", "floor", "ceil", "round", "trunc", "sign", "neg",
         "reciprocal", "square", "expm1", "erf", "sigmoid", "frac"]
POSITIVE = {"log", "log1p", "log2", "log10", "sqrt", "rsqrt"}
UNIT = {"asin", "acos", "atanh"}
SHAPES = [(4,), (3, 5), (2, 1, 3), ()]


def _unary_input(name, shape, dtype, rng):
    x = rng.standard_normal(shape)
    if name in UNIT:
        x = np.clip(x, -0.99, 0.99)
    if name in POSITIVE:
        x = np.abs(x) + 0.1
    if name == "reciprocal":
        x = np.where(np.abs(x) < 0.1, 0.5, x)
    return np.asarray(x, dtype)


@pytest.mark.parametrize("name", UNARY)
def test_unary_shapes_and_dtypes_match_jax(name):
    rng = np.random.default_rng(7)
    for dtype in (np.float32, np.float64):
        for shape in SHAPES:
            x = _unary_input(name, shape, dtype, rng)
            want = getattr(paddle, name)(paddle.to_tensor(x)).numpy()
            got = getattr(pt, name)(pt.to_tensor(x, place="cpu"))
            assert cs._map64(str(got.dtype)[6:]) == str(want.dtype)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{dtype} {shape}")


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod"])
def test_reduction_axes_match_jax(name):
    x = np.random.default_rng(7).standard_normal((3, 4, 5)).astype(
        np.float32)
    for axis in [None, 0, 1, 2, -1, (0, 2), [1, 2], []]:
        for keepdim in (False, True):
            want = getattr(paddle, name)(paddle.to_tensor(x), axis=axis,
                                         keepdim=keepdim).numpy()
            got = getattr(pt, name)(pt.to_tensor(x, place="cpu"),
                                    axis=axis, keepdim=keepdim).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"axis={axis} keep={keepdim}")


# -- the promotion matrix ---------------------------------------------------
from test_op_parity_sweep import PROMOTION_CASES  # noqa: E402

_NARROW = {"float32", "int32", "bool", "bfloat16", "float16"}


def _mk(pkg, d, **kw):
    if d == "bool":
        return pkg.to_tensor(np.asarray([True, False]), **kw)
    return pkg.to_tensor(np.asarray([1, 0]), dtype=d, **kw)


@pytest.mark.parametrize("da,db,expect", PROMOTION_CASES,
                         ids=[f"{a}+{b}" for a, b, _ in PROMOTION_CASES])
def test_dtype_promotion_matches_jax(da, db, expect):
    """The JAX package's pinned table, after mapping the port's 64-bit
    results to 32 bits; between operands of 32 bits or fewer, equal as
    they are."""
    for x, y in [(_mk(pt, da, place="cpu"), _mk(pt, db, place="cpu")),
                 (_mk(pt, db, place="cpu"), _mk(pt, da, place="cpu"))]:
        got = str(pt.add(x, y).dtype)[6:]
        assert cs._map64(got) == expect
        if da in _NARROW and db in _NARROW:
            assert got == expect
    jx = paddle.multiply(_mk(paddle, da), _mk(paddle, db))
    px = pt.multiply(_mk(pt, da, place="cpu"), _mk(pt, db, place="cpu"))
    assert cs._map64(str(px.dtype)[6:]) == str(jx.dtype)


def test_python_scalars_promote_as_jax_weak_types():
    for d in ("int32", "float32", "bfloat16", "float16"):
        for s in (2, 2.5, True):
            jx = paddle.add(_mk(paddle, d), s)
            px = pt.add(_mk(pt, d, place="cpu"), s)
            assert str(px.dtype)[6:] == str(jx.dtype), (d, s)


# -- to_tensor --------------------------------------------------------------
def test_to_tensor_follows_the_jax_rules():
    cpu = dict(place="cpu")
    assert pt.to_tensor(np.zeros(3), **cpu).dtype == torch.float32
    assert pt.to_tensor([1.5, 2.0], **cpu).dtype == torch.float32
    assert pt.to_tensor(1.5, **cpu).shape == ()
    assert pt.to_tensor(np.zeros(2, np.complex128), **cpu).dtype == \
        torch.complex64
    assert pt.to_tensor(3, **cpu).dtype == torch.int64
    assert pt.to_tensor(True, **cpu).dtype == torch.bool
    assert pt.to_tensor(np.zeros(2), dtype="float64",
                        **cpu).dtype == torch.float64
    assert pt.to_tensor([1, 2], dtype="bfloat16", **cpu).dtype == \
        torch.bfloat16
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False, **cpu)
    assert x.requires_grad and x.is_leaf
    assert not pt.to_tensor([1, 2], stop_gradient=False, **cpu).requires_grad
    y = pt.to_tensor(x, **cpu)
    assert not y.requires_grad and y.data_ptr() != x.data_ptr()
    for data in (np.zeros(3), [1.5, 2.0], 3, True, np.arange(4)):
        assert cs._map64(str(pt.to_tensor(data, **cpu).dtype)[6:]) == str(
            paddle.to_tensor(data).dtype)
    pt.set_default_dtype("float64")
    paddle.set_default_dtype("float64")
    try:
        assert pt.get_default_dtype() == "float64"
        assert pt.to_tensor([1.5], **cpu).dtype == torch.float64
        assert str(pt.ones([2], **{}).dtype) == "torch.float64"
        with pytest.raises(TypeError):
            pt.set_default_dtype("int32")
    finally:
        pt.set_default_dtype("float32")
        paddle.set_default_dtype("float32")
    assert pt.get_default_dtype() == str(paddle.get_default_dtype())
    assert pt.is_tensor(x) and not pt.is_tensor(np.zeros(2))
    assert pt.Tensor is torch.Tensor


def test_index_results_are_int64_and_asked_64_bits_kept():
    x = pt.to_tensor(np.arange(6.0).reshape(2, 3), dtype="float64",
                     place="cpu")
    assert x.dtype == torch.float64
    assert pt.sum(x).dtype == torch.float64
    for out in (pt.argmax(x, axis=1), pt.argsort(x), pt.topk(x, 2)[1],
                pt.nonzero(x)):
        assert out.dtype == torch.int64


def test_no_silent_cpu_fallback():
    """Without a place the tensor goes to the framework's device, CUDA by
    default, and without CUDA that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from paddle_tpu_torch.framework import device as dmod
    before = dmod._current_device
    dmod._current_device = "cuda"
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.randn([2])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.to_tensor([1.0], place="gpu:0")
    finally:
        dmod._current_device = before


# -- coverage of the JAX package's public names -----------------------------
# Names that are the JAX Tensor's machinery, not ops: ``apply``/``nondiff``
# record a node per op on the JAX package's own tape (torch's autograd
# records the port's ops), ``raw`` unwraps the JAX Tensor's array (the
# port's tensor is the array), ``builtins_*`` are saved python builtins.
NOT_OPS = {"apply", "nondiff", "raw", "builtins_abs", "builtins_all",
           "builtins_min", "builtins_slice", "builtins_sorted",
           "builtins_sum"}
# Counterparts that live elsewhere in the port (``next_key``'s is the
# device generator ``framework.random_seed.generator``).
ELSEWHERE = {"unary": "tensor_ops._factory", "binary": "tensor_ops._factory",
             "reduction": "tensor_ops._factory",
             "next_key": "framework.random_seed"}
# Names the port lacks, each with the ROADMAP.md item that takes it.
_NOT_YET = {
    "functional_mode": "ROADMAP.md Queue 1 item 9, the eager surface's "
                       "rest (the JAX tape's trace switch)",
}


def _public(mod, pred=callable):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and pred(getattr(mod, n))
                  and not isinstance(getattr(mod, n), types.ModuleType))


def _missing(names, has):
    return [n for n in names if not has(n) and n not in _NOT_YET]


def test_every_tensor_op_has_a_counterpart():
    import importlib
    names = _public(jax_ops)
    assert len(names) >= 296
    missing = []
    for n in names:
        if n in NOT_OPS:
            continue
        if n in ELSEWHERE:
            mod = importlib.import_module("paddle_tpu_torch." + ELSEWHERE[n])
            ok = hasattr(mod, n) or (n == "next_key"
                                     and hasattr(mod, "generator"))
        else:
            ok = callable(getattr(pt, n, None))
        if not ok and n not in _NOT_YET:
            missing.append(n)
    assert not missing, missing


def test_every_autograd_name_has_a_counterpart():
    names = sorted(set(_public(jax_autograd, lambda v: True))
                   | set(jax_autograd._LAZY))
    names += ["Jacobian", "Hessian", "forward_grad", "set_grad_enabled"]
    assert not _missing(names, lambda n: hasattr(pt.autograd, n))
    for n in ("tape", "functional", "py_layer"):
        __import__("paddle_tpu_torch.autograd." + n)


def test_every_activation_has_a_counterpart():
    names = [n for n in _public(jax_activation) if n not in ("apply",
                                                             "unary")]
    assert len(names) >= 34
    assert not _missing(names, lambda n: callable(getattr(
        pt.nn.functional, n, None)))


def test_every_layer_method_has_a_counterpart():
    names = _public(jax_nn.Layer)
    assert len(names) >= 30
    assert not _missing(names, lambda n: hasattr(pt.nn.Layer, n))


def test_not_yet_names_are_queued():
    text = open(cs.__file__.replace("chip_smoke.py", "ROADMAP.md")).read()
    for n in _NOT_YET:
        assert f"`{n}`" in text, n
