"""The port's losses against the JAX package's: the loss rows of
``chip_smoke.nn_cases`` (every function of ``nn.functional.loss`` and
every loss layer) at ``NN_ROWS_CPU`` size, the same seeded numpy inputs
through both packages on the CPU: outputs within the row's ``OP_TOL``
class, dtypes equal after JAX's 64 -> 32, the gradient of ``sum(loss *
w)`` (a loss layer's: the input's and every parameter's) within
``GRAD_TOL``, a loss layer's state dict keys JAX's. Beside the table:
``cross_entropy``'s weighted "mean" over the labels not ignored,
``ctc_loss``'s reductions and ``edit_distance``'s lengths.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import cases, run_row

CASES = cases("loss")


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_loss_matches_jax(case):
    err = run_row(case)
    assert err is None, err


def _both(fn, *arrays, **kw):
    """``fn`` of each package on the same numpy inputs, as numpy."""
    j = getattr(paddle.nn.functional, fn)(
        *[paddle.to_tensor(a) for a in arrays], **kw)
    t = getattr(pt.nn.functional, fn)(
        *[torch.from_numpy(a) for a in arrays], **kw)
    return np.asarray(t.detach().numpy()), np.asarray(j.numpy())


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_weighted_mean_and_ignored_rows(reduction):
    r = np.random.default_rng(3)
    x = r.standard_normal((6, 5)).astype(np.float32)
    y = np.array([0, 4, -100, 2, -100, 1], np.int64)
    w = r.uniform(0.5, 2, 5).astype(np.float32)
    got, want = _both("cross_entropy", x, y, w, reduction=reduction)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_every_label_ignored_is_zero():
    x = np.ones((3, 4), np.float32)
    y = np.full((3,), -100, np.int64)
    got, want = _both("cross_entropy", x, y)
    assert float(got) == float(want) == 0.0


def test_ctc_loss_mean_divides_by_label_length():
    r = np.random.default_rng(4)
    x = r.standard_normal((7, 3, 5)).astype(np.float32)
    lab = r.integers(1, 5, (3, 3)).astype(np.int32)
    il = np.array([7, 6, 5], np.int32)
    ll = np.array([3, 2, 1], np.int32)
    for red in ("mean", "sum", "none"):
        got, want = _both("ctc_loss", x, lab, il, ll, reduction=red)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_edit_distance_normalized_and_lengths():
    r = np.random.default_rng(5)
    a = r.integers(0, 4, (4, 6)).astype(np.int64)
    b = r.integers(0, 4, (4, 5)).astype(np.int64)
    il, ll = np.array([6, 3, 0, 5], np.int64), np.array([5, 5, 2, 0],
                                                        np.int64)
    for norm in (True, False):
        got = pt.nn.functional.edit_distance(
            torch.from_numpy(a), torch.from_numpy(b), norm,
            input_length=torch.from_numpy(il),
            label_length=torch.from_numpy(ll))
        want = paddle.nn.functional.loss.edit_distance(
            paddle.to_tensor(a), paddle.to_tensor(b), norm,
            input_length=paddle.to_tensor(il),
            label_length=paddle.to_tensor(ll))
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        assert int(got[1]) == int(want[1])
