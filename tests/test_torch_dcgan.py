"""Phase 28c's model on the CPU: ``chip_smoke.dcgan`` (DCGAN's generator
and discriminator written once on paddle's surface: ``Conv2DTranspose``
/ ``Conv2D`` with N(0, 0.02) ``ParamAttr`` weights, ``BatchNorm2D``,
``ReLU`` / ``LeakyReLU``, ``Tanh`` / ``Sigmoid``) at tiny widths (z 8,
base width 16, 64 x 64 x 3 images, batch 2), built with ``paddle`` bound
to each package in turn and the weights copied by state dict key: the
generated images and scores, the BCE losses and every gradient within
1e-5 relative, then 3 of ``chip_smoke.dcgan_step``'s alternating Adam(2e-4,
beta1 0.5) D/G steps: losses, parameters and batch-norm buffers within
1e-5.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import state_arrays

RTOL = 1e-5
TINY = dict(nz=8, width=16, channels=3)


@pytest.fixture(scope="module", autouse=True)
def cpu_one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with cs.using_device("cpu"):
        yield
    torch.set_num_threads(before)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy())


@pytest.fixture(scope="module")
def pair():
    pt.seed(11)
    g, d = cs.dcgan(pt, **TINY)
    jg, jd = cs.dcgan(paddle, **TINY)
    for a, b in ((g, jg), (d, jd)):
        # parameters in the same order; the batch norms' buffers follow
        # each layer in torch's state dict, all parameters in JAX's
        assert [n for n, _ in a.named_parameters()] == \
            [n for n, _ in b.named_parameters()]
        assert sorted(a.state_dict()) == sorted(b.state_dict())
        b.set_state_dict(state_arrays(a))
    r = np.random.default_rng(12)
    real = r.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    z = r.standard_normal((2, TINY["nz"], 1, 1)).astype(np.float32)
    return (g, d), (jg, jd), real, z


def test_forward_and_every_gradient_match_jax(pair):
    (g, d), (jg, jd), real, z = pair
    out = []
    for pk, gen, disc, conv in ((pt, g, d, torch.from_numpy),
                                (paddle, jg, jd, paddle.to_tensor)):
        fake = gen(conv(z))
        score = disc(fake)
        loss = pk.nn.BCELoss()(score, pk.ones([2, 1, 1, 1],
                                              dtype="float32")) + \
            pk.nn.BCELoss()(disc(conv(real)), pk.zeros([2, 1, 1, 1],
                                                       dtype="float32"))
        loss.backward()
        grads = {f"{tag}.{n}": _np(p.grad) for tag, m in (("g", gen),
                                                         ("d", disc))
                 for n, p in m.named_parameters()}
        out.append((_np(fake), _np(score), float(_np(loss)), grads))
        for m in (gen, disc):
            m.clear_gradients()
    (f, s, l, gr), (jf, js, jl, jgr) = out
    assert f.shape == (2, 3, 64, 64) and s.shape == (2, 1, 1, 1)
    assert _rel(f, jf) < RTOL and _rel(s, js) < RTOL
    np.testing.assert_allclose(l, jl, rtol=RTOL)
    assert len(gr) == len(jgr) == 24
    for n in gr:
        assert _rel(gr[n], jgr[n]) < RTOL, n


def test_three_adam_steps_match_jax(pair):
    (g, d), (jg, jd), real, z = pair
    jg.set_state_dict(state_arrays(g))
    jd.set_state_dict(state_arrays(d))
    res = []
    for pk, gen, disc, conv in ((pt, g, d, torch.from_numpy),
                                (paddle, jg, jd, paddle.to_tensor)):
        og, od = (pk.optimizer.Adam(learning_rate=2e-4, beta1=0.5,
                                    parameters=m.parameters())
                  for m in (gen, disc))
        losses = [tuple(float(_np(v)) for v in cs.dcgan_step(
            pk, gen, disc, og, od, conv(real), conv(z))) for _ in range(3)]
        res.append((losses, {**{"g." + k: v for k, v in
                                state_arrays(gen).items()},
                             **{"d." + k: v for k, v in
                                state_arrays(disc).items()}}))
    (tl, ta), (jl, ja) = res
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert set(ta) == set(ja)
    for k in ta:
        assert _rel(ta[k], ja[k]) < RTOL, k
