"""ViT and ``Conv2D`` on the PyTorch port against the JAX package's, on
the CPU.

- ``Conv2D`` / ``F.conv2d`` in fp32 within ``FWD_TOL`` (1e-5 relative and
  absolute) over strides, every padding form (int, per dim, per-side
  pairs, nested, "SAME" with an odd total, "VALID"), dilation, groups and
  with and without a bias; under ``amp.auto_cast`` O1 the output dtype is
  JAX's (bf16) and its values agree to bf16 rounding;
- ``VisionTransformer`` at ``vit_s_16``'s widths (384, 6 heads) cut to
  depth 2 at 32 x 32 (four patches and the class token), dropout 0: the
  logits within ``FWD_TOL``, and three fleet + AdamW(1e-3) steps of the
  fp32 CE over 1000 classes (``bench_vit``'s loss): losses within 2e-4
  relative, the parameters under ``torch_parity.assert_params_close``;
- planted faults that must fail: the encoder post-LN instead of pre-LN,
  and "SAME"'s odd row on the low side.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_parity as P
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision.models import vit as jvit
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import conv as conv_mod
from paddle_tpu_torch.vision.models import vit

VIT = dict(img_size=32, embed_dim=384, depth=2, num_heads=6)   # vit_s_16's
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with P.torch_threads(1):
        yield


# (in, out, kernel, stride, padding, dilation, groups, bias)
CONV_CASES = {
    "3x3 s1 p0": (4, 8, 3, 1, 0, 1, 1, True),
    "3x3 s2 p1": (4, 8, 3, 2, 1, 1, 1, True),
    "patch 4 s4": (3, 16, 4, 4, 0, 1, 1, True),
    "per dim (1, 2)": (4, 6, (3, 5), 1, (1, 2), 1, 1, False),
    "per side [0, 1, 2, 1]": (4, 6, 3, (2, 1), [0, 1, 2, 1], 1, 1, True),
    "nested NCHW": (4, 6, 3, 1, [[0, 0], [0, 0], [1, 0], [2, 1]], 1, 1,
                    True),
    "SAME s2": (4, 8, 4, 2, "SAME", 1, 1, True),
    "SAME dilated": (4, 8, 3, 1, "same", 2, 1, True),
    "VALID": (4, 8, 3, 2, "VALID", 1, 1, False),
    "groups 2": (4, 8, 3, 1, 1, 1, 2, True),
    "depthwise": (4, 4, 3, 1, 1, 1, 4, False),
}


def _conv_pair(cin, cout, k, s, p, d, g, bias):
    """The port's ``Conv2D`` and JAX's ``F.conv2d`` on its weights (a JAX
    ``Conv2D`` would compile its initialisers for every shape)."""
    tc = nn.Conv2D(cin, cout, k, stride=s, padding=p, dilation=d, groups=g,
                   bias_attr=None if bias else False, device="cpu")
    w = tc.weight.detach().numpy()
    b = None if tc.bias is None else tc.bias.detach().numpy()

    def jc(x):
        return JF.conv2d(x, JTensor(w), None if b is None else JTensor(b),
                         stride=s, padding=p, dilation=d, groups=g)
    return jc, tc


def _image(c, hw=(11, 13), seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, c) + hw).astype(np.float32)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    jc, tc = _conv_pair(*CONV_CASES[case])
    x = _image(CONV_CASES[case][0])
    want = P.jax_call(jc, x)
    with torch.no_grad():
        got = tc(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)


def test_conv2d_under_o1_casts_as_jax():
    jc, tc = _conv_pair(*CONV_CASES["3x3 s2 p1"])
    x = _image(4)

    def jf(a):
        with jamp.auto_cast(level="O1"):
            return jc(a)
    want = P.jax_call(jf, x)
    with torch.no_grad(), amp.auto_cast(level="O1"):
        got = tc(torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_conv2d_refuses_channels_last():
    """Channels-last convolution is in the port since the CNN slice: an
    NHWC input gives the NHWC view of the NCHW result (held to JAX in
    ``test_torch_vision_cnn.py``). What is refused is a format that is
    neither, and a padding mode paddle does not have; "reflect" pads the
    input with ``F.pad`` and convolves it unpadded."""
    x = torch.from_numpy(_image(3))
    w = torch.from_numpy(_image(3, (1, 1), seed=1)[:2].copy())
    nchw = F.conv2d(x, w)
    nhwc = F.conv2d(x.permute(0, 2, 3, 1), w, data_format="NHWC")
    np.testing.assert_allclose(nhwc.permute(0, 3, 1, 2).numpy(),
                               nchw.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="NCHW or NHWC"):
        F.conv2d(x, w, data_format="NDHWC")
    with pytest.raises(ValueError, match="NCHW or NHWC"):
        nn.Conv2D(3, 2, 1, data_format="HWCN", device="cpu")
    conv = nn.Conv2D(3, 2, 3, padding=1, padding_mode="reflect",
                     device="cpu")
    want = F.conv2d(F.pad(x, [1, 1, 1, 1], mode="reflect"), conv.weight,
                    conv.bias)
    np.testing.assert_allclose(conv(x).detach().numpy(),
                               want.detach().numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="padding_mode"):
        nn.Conv2D(3, 2, 3, padding_mode="mirror", device="cpu")


@pytest.fixture(scope="module")
def vits():
    """(JAX VisionTransformer holding the port's weights, the port's
    model: seed 0)."""
    pt.seed(0)
    tm = vit.VisionTransformer(**VIT, device="cpu")
    return P.jax_copy(lambda: jvit.VisionTransformer(**VIT), tm), tm


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 1000, (B,)).astype(np.int64))


def test_vit_logits(vits, batch):
    jm, tm = vits
    assert P.arrays(tm).keys() == P.arrays(jm).keys()
    want = P.jax_call(jm, batch[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(batch[0]))
    assert got.shape == (B, 1000)
    np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)


def _jax_loss(m, x, y):
    return JF.cross_entropy(m(x).astype("float32"), y)


def _port_loss(m, x, y):
    return F.cross_entropy(m(x).float(), y.to(m.device))


def test_three_fleet_adamw_steps_match_jax(vits, batch):
    jm, _ = vits
    init, want_losses, want = P.jax_train(copy.deepcopy(jm), _jax_loss,
                                          *batch)
    model = vit.VisionTransformer(**VIT, device="cpu")
    load_numpy_state_dict(model, init)
    losses, got = P.port_train(model, _port_loss, *batch)
    np.testing.assert_allclose(losses, want_losses, rtol=P.LOSS_RTOL)
    assert losses[2] < losses[0]
    P.assert_params_close(got, want, exempt=("k_proj.bias",))


def test_planted_faults_fail(vits, batch, monkeypatch):
    """A post-LN encoder, and "SAME" padding with its odd row on the low
    side, must each fail their checks."""
    jm, tm = vits
    want = P.jax_call(jm, batch[0])
    for layer in tm.encoder.layers:
        layer.normalize_before = False
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(batch[0]))
    finally:
        for layer in tm.encoder.layers:
            layer.normalize_before = True
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)

    jc, tc = _conv_pair(*CONV_CASES["SAME s2"])
    x = _image(4)
    want = P.jax_call(jc, x)
    same = conv_mod._same_pads
    monkeypatch.setattr(conv_mod, "_same_pads", lambda *a: [
        (hi, lo) for lo, hi in same(*a)])
    with torch.no_grad():
        got = tc(torch.from_numpy(x))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), want, **P.FWD_TOL)
