"""Phase 28b's model on the CPU: ``chip_smoke.seq2seq`` (PaddleNLP's
attention seq2seq written once on paddle's surface: ``Embedding(
padding_idx=)``, a 2-layer ``LSTM`` encoder, an ``RNNCellBase`` decoder
cell of two ``LSTMCell``s with dot-product attention under the padding
mask) at tiny widths, dropout 0, built with ``paddle`` bound to each
package in turn and the weights copied by state dict key: the loss, every
gradient and 3 Adam steps under ``ClipGradByGlobalNorm(5.0)`` within
1e-5 relative, beam decoding (``BeamSearchDecoder`` + ``dynamic_decode``
on the tiled encoder outputs) token-identical with scores within 1e-5,
``predicted_ids`` the numpy backtrace of the step tokens, and
``beam_size=1`` the greedy loop over the same cell.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import state_arrays

RTOL = 1e-5
S2S_TINY = dict(src_vocab=41, trg_vocab=29, hidden=8, layers=2,
                dropout=0.0)


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
def s2s_pair():
    pt.seed(9)
    tm = cs.seq2seq(pt, **S2S_TINY)
    jm = cs.seq2seq(paddle, **S2S_TINY)
    assert list(tm.state_dict()) == list(jm.state_dict())
    jm.set_state_dict(state_arrays(tm))
    batch = cs.seq2seq_batch(3, 7, (3, 7), S2S_TINY["src_vocab"],
                             S2S_TINY["trg_vocab"], seed=2)
    return tm, jm, batch


def _s2s_steps(pk, model, batch, conv, steps=3):
    opt = pk.optimizer.Adam(learning_rate=1e-2,
                            parameters=model.parameters(),
                            grad_clip=pk.nn.ClipGradByGlobalNorm(5.0))
    src, sl, ti, to, tl = (conv(a) for a in batch)
    losses, grads = [], None
    for i in range(steps):
        loss = cs.seq2seq_loss(pk, model(src, sl, ti), to, tl)
        loss.backward()
        if i == 0:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(_np(loss)))
    return losses, grads, state_arrays(model)


def test_seq2seq_trains_as_jax(s2s_pair):
    tm, jm, batch = s2s_pair
    tl, tg, ta = _s2s_steps(pt, tm, batch, torch.from_numpy)
    jl, jg, ja = _s2s_steps(paddle, jm, batch, paddle.to_tensor)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    for n in tg:
        assert _rel(tg[n], jg[n]) < RTOL, n
    for n in ta:
        assert _rel(ta[n], ja[n]) < RTOL, n


def test_seq2seq_beam_decode_is_token_identical(s2s_pair):
    tm, jm, batch = s2s_pair
    jm.set_state_dict(state_arrays(tm))
    tm.eval()
    jm.eval()
    got = cs.beam_decode(pt, tm, torch.from_numpy(batch[0]),
                         torch.from_numpy(batch[1]), 4, 10)
    want = cs.beam_decode(paddle, jm, paddle.to_tensor(batch[0]),
                          paddle.to_tensor(batch[1]), 4, 10)
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(_np(got[i]), np.asarray(
            want[i].numpy() if hasattr(want[i], "numpy") else want[i]))
    np.testing.assert_allclose(_np(got[2]), want[2].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        _np(got[0]).transpose(1, 0, 2),
        cs.np_backtrace(_np(got[4]), _np(got[1]).transpose(1, 0, 2)))
    b1 = cs.beam_decode(pt, tm, torch.from_numpy(batch[0]),
                        torch.from_numpy(batch[1]), 1, 10)[0]
    greedy = cs.greedy_decode(pt, tm, torch.from_numpy(batch[0]),
                              torch.from_numpy(batch[1]), b1.shape[1])
    assert torch.equal(b1[:, :, 0], greedy)
