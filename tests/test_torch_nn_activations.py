"""The port's activation layers against the JAX package's: the activation
rows of ``chip_smoke.nn_cases`` (every layer of
``paddle_tpu/nn/layer/activation.py``) at ``NN_ROWS_CPU`` size, each layer
built from seed 0 (``PReLU``'s weight copied into the JAX layer by its
state dict key), the same seeded numpy inputs through both packages on
the CPU: outputs within 2e-6, the input's and every parameter's gradient
within ``GRAD_TOL``; ``RReLU`` in training by shape and dtype (its slopes
are random), and in eval as ``leaky_relu`` with the mean slope.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import cases, run_row

CASES = cases("activations")


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_activation_layer_matches_jax(case):
    err = run_row(case)
    assert err is None, err


def test_rrelu_in_eval_is_the_mean_slope():
    x = np.random.default_rng(3).standard_normal((4, 5)).astype(np.float32)
    layer, jlayer = pt.nn.RReLU(0.1, 0.3), paddle.nn.RReLU(0.1, 0.3)
    layer.eval()
    jlayer.eval()
    got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jlayer(paddle.to_tensor(x)).numpy(),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, np.where(x >= 0, x, 0.2 * x),
                               rtol=2e-6, atol=2e-6)
