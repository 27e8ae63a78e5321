"""The port's ``nn.functional`` against the JAX package's: the common,
normalisation and convolution rows of ``chip_smoke.nn_cases`` (the table
phase 28a also runs on the card; the loss, pooling/vision and layer rows
are in ``test_torch_nn_{losses,vision,layers}.py`` and ``test_torch_rnn.py``)
at ``NN_ROWS_CPU`` size, the same seeded numpy inputs through
``paddle_tpu.nn.functional.<f>`` and ``paddle_tpu_torch.nn.functional.<f>``
on the CPU: outputs within the row's ``OP_TOL`` class (integer, mask and
index results bit for bit), dtypes equal after JAX's 64 -> 32, and the
gradient of ``sum(f(x) * w)`` within ``GRAD_TOL`` where the function is
differentiable. Every ``interpolate`` mode is held at an up and a down
scale. Beside the table: the coverage of ``paddle_tpu.nn`` and
``nn.functional``'s public names (``_NOT_YET``: the five names queued in
ROADMAP.md).
"""
import types

import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import cases, run_row

CASES = cases("functional")

# Not API: JAX's own modules and helpers in the namespaces' dir().
NOT_API = {"jax", "jnp", "vision", "extension", "annotations", "apply",
           "unary"}
# Names the next slice takes, each in backticks in ROADMAP.md.
_NOT_YET = {"utils", "spectral_norm", "SpectralNorm", "sparse_attention",
            "class_center_sample"}


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_functional_matches_jax(case):
    err = run_row(case)
    assert err is None, err


def test_every_interpolate_mode_is_held_up_and_down():
    tags = {c.tag for c in CASES if c.name == "F.interpolate"}
    for mode in ("nearest", "bilinear", "bicubic", "area"):
        assert {f"{mode} up", f"{mode} down"} <= tags


def _names(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and n not in NOT_API)


@pytest.mark.parametrize("ns", ["nn", "nn.functional"])
def test_every_nn_name_has_a_counterpart(ns):
    jmod = paddle.nn if ns == "nn" else paddle.nn.functional
    tmod = pt.nn if ns == "nn" else pt.nn.functional
    names = _names(jmod)
    assert len(names) >= (130 if ns == "nn" else 110)
    missing = [n for n in names if not hasattr(tmod, n)]
    assert sorted(set(missing) - _NOT_YET) == []
    assert set(missing) == _NOT_YET & set(names)
    for n in names:
        if n not in missing and not isinstance(getattr(jmod, n),
                                               types.ModuleType):
            assert callable(getattr(tmod, n)), n


def test_not_yet_names_are_queued():
    text = open(cs.__file__.replace("chip_smoke.py", "ROADMAP.md")).read()
    for n in _NOT_YET:
        assert f"`{n}`" in text, n


def test_results_stay_on_the_input_device():
    """Every tensor the resize, pad, norm and conv paths make is made on
    the input's device: on torch's "meta" device (shapes, no data) each
    result is a meta tensor of the JAX package's shape, so nothing is
    moved to the CPU on the way."""
    F = pt.nn.functional
    x = torch.empty(2, 4, 6, 6, device="meta")
    for f, shape in (
            (lambda t: F.interpolate(t, size=[4, 9], mode="bicubic"),
             (2, 4, 4, 9)),
            (lambda t: F.interpolate(t, scale_factor=2), (2, 4, 12, 12)),
            (lambda t: F.pad(t, [1, 2, 0, 3], mode="reflect"),
             (2, 4, 9, 9)),
            (lambda t: F.group_norm(t, 2), (2, 4, 6, 6)),
            (lambda t: F.local_response_norm(t, 4), (2, 4, 6, 6)),
            (lambda t: F.conv2d_transpose(
                t, torch.empty(4, 3, 3, 3, device="meta"), stride=2,
                padding=[1, 0, 2, 1]), (2, 3, 12, 10))):
        out = f(x)
        assert out.device.type == "meta" and tuple(out.shape) == shape
