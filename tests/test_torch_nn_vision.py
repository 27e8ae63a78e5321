"""Pooling masks, unpooling, the vision and the extension functionals
of the port against the JAX package's: their rows of
``chip_smoke.nn_cases`` (``max_pool*d`` / ``adaptive_max_pool*d`` with
``return_mask``, ``max_unpool*d`` and ``MaxUnPool*D``, ``pixel_shuffle``,
``pixel_unshuffle``, ``channel_shuffle``, ``affine_grid``,
``grid_sample``, ``diag_embed``, ``sequence_mask``, ``gather_tree``,
``temporal_shift``) at ``NN_ROWS_CPU`` size on the CPU. Masks and indices
bit for bit (the inputs are drawn from {0, 1, 2}, so ties decide them),
floats within the row's ``OP_TOL`` class, gradients within
``GRAD_TOL``. Beside the table: a mask fed back to ``max_unpool2d``
restores each maximum in place, as in the JAX package.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import cases, run_row

CASES = cases("vision")


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_vision_row_matches_jax(case):
    err = run_row(case)
    assert err is None, err


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pool_mask_round_trips_through_unpool(fmt):
    x = np.random.default_rng(7).standard_normal((2, 3, 6, 6)).astype(
        np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    F, JF = pt.nn.functional, paddle.nn.functional
    out, mask = F.max_pool2d(torch.from_numpy(x), 2, return_mask=True,
                             data_format=fmt)
    jout, jmask = JF.max_pool2d(paddle.to_tensor(x), 2, return_mask=True,
                                data_format=fmt)
    np.testing.assert_array_equal(mask.numpy(), jmask.numpy())
    back = F.max_unpool2d(out, mask, 2, data_format=fmt)
    jback = JF.max_unpool2d(jout, jmask, 2, data_format=fmt)
    np.testing.assert_array_equal(back.numpy(), jback.numpy())
    assert float((back != 0).sum()) == out.numel()
