"""The port's recurrent layers and seq2seq decoding against the JAX
package's.

- The recurrent rows of ``chip_smoke.nn_cases`` (the three cells, ``RNN``,
  ``BiRNN``, ``SimpleRNN``, ``LSTM``, ``GRU``) at ``NN_ROWS_CPU`` size, and
  each multi-layer layer at 1 and 2 layers, forward and bidirectional,
  batch- and time-major, with and without given initial states: outputs
  and final states within 1e-5 relative (each layer in two
  configurations that between them cover every option), the input's and every
  parameter's gradient within ``GRAD_TOL``, state dict keys equal (a
  ``BiRNN``'s cells once, under ``rnn_fw.cell``/``rnn_bw.cell``).
- ``BeamSearchDecoder`` + ``dynamic_decode`` on a tiny cell whose logits
  tie (two vocabulary columns equal) and whose end token fires: predicted
  ids, parent ids and lengths equal to JAX's, scores within 1e-5, a
  keyword argument reaching the cell.

Phase 28b's seq2seq model is held in ``test_torch_seq2seq.py``.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt

from torch_nn_parity import cases, run_row, state_arrays

CASES = cases("rnn")
RTOL = 1e-5


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


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_rnn_row_matches_jax(case):
    err = run_row(case)
    assert err is None, err


# (mode, layers, direction, time_major, initial states given)
CONFIGS = [(m, *c) for m in ("SimpleRNN", "LSTM", "GRU") for c in (
    (1, "forward", False, False), (2, "bidirect", True, True))]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[
    f"{m}-{n}-{d}-{'tm' if t else 'bm'}-{'h0' if h else 'zeros'}"
    for m, n, d, t, h in CONFIGS])
def test_multilayer_rnn_matches_jax(cfg):
    mode, layers, direction, time_major, given = cfg
    B, T, F, H = 2, 5, 3, 4
    dirs = 2 if direction != "forward" else 1
    pt.seed(3)
    layer = getattr(pt.nn, mode)(F, H, layers, direction, time_major,
                                 device="cpu")
    jl = getattr(paddle.nn, mode)(F, H, layers, direction, time_major)
    assert list(layer.state_dict()) == list(jl.state_dict())
    jl.set_state_dict(state_arrays(layer))
    r = np.random.default_rng(4)
    x = r.standard_normal((T, B, F) if time_major else (B, T, F)).astype(
        np.float32)
    h0 = [r.standard_normal((layers * dirs, B, H)).astype(np.float32)
          for _ in range(2 if mode == "LSTM" else 1)]
    xt = torch.from_numpy(x).requires_grad_()
    jx = paddle.to_tensor(x, stop_gradient=False)
    init = (None if not given else
            tuple(torch.from_numpy(h) for h in h0) if mode == "LSTM"
            else torch.from_numpy(h0[0]))
    jinit = (None if not given else
             tuple(paddle.to_tensor(h) for h in h0) if mode == "LSTM"
             else paddle.to_tensor(h0[0]))
    out, st = layer(xt, init)
    jout, jst = jl(jx, jinit)
    assert out.shape == tuple(jout.shape) == (
        (T, B, dirs * H) if time_major else (B, T, dirs * H))
    assert _rel(_np(out), jout.numpy()) < RTOL
    for a, b in zip(st if mode == "LSTM" else [st],
                    jst if mode == "LSTM" else [jst]):
        assert tuple(a.shape) == (layers * dirs, B, H)
        assert _rel(_np(a), b.numpy()) < RTOL
    w = cs.weights_for(tuple(out.shape))
    (out * torch.from_numpy(w)).sum().backward()
    paddle.sum(jout * paddle.to_tensor(w)).backward()
    assert _rel(xt.grad.numpy(), jx.grad.numpy()) < RTOL
    jp = dict(jl.named_parameters())
    for name, p in layer.named_parameters():
        assert _rel(p.grad.numpy(), jp[name].grad.numpy()) < RTOL, name


def test_birnn_keeps_each_cell_once():
    pt.seed(0)
    bi = pt.nn.BiRNN(pt.nn.GRUCell(3, 4), pt.nn.GRUCell(3, 4))
    jbi = paddle.nn.BiRNN(paddle.nn.GRUCell(3, 4), paddle.nn.GRUCell(3, 4))
    assert list(bi.state_dict()) == list(jbi.state_dict())
    assert bi.cell_fw is bi.rnn_fw.cell and bi.cell_bw is bi.rnn_bw.cell
    assert len(bi.parameters()) == 8


def test_sequence_length_is_refused():
    lstm = pt.nn.LSTM(3, 4, device="cpu")
    x = torch.zeros(2, 5, 3)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        lstm(x, sequence_length=torch.tensor([5, 3]))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        pt.nn.RNN(pt.nn.GRUCell(3, 4))(x, sequence_length=[5, 3])


def test_initial_states_follow_state_shape():
    cell = pt.nn.LSTMCell(3, 4)
    h, c = cell.get_initial_states(torch.zeros(5, 3), init_value=0.5)
    assert h.shape == c.shape == (5, 4) and float(h[0, 0]) == 0.5
    g = pt.nn.GRUCell(3, 4).get_initial_states(torch.zeros(2, 7, 3),
                                                batch_dim_idx=1)
    assert g.shape == (7, 4) and g.dtype == torch.float32


# -- beam search ---------------------------------------------------------------

V, HID, BEAM, EOS = 9, 6, 3, 2


def tiny_decoder(paddle_):
    """A cell, its embedding and a vocabulary projection (``_tied`` makes
    its columns 3 and 4 equal: their logits tie at every step, among the
    best candidates)."""
    nn = paddle_.nn

    class Cell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.ih = nn.Linear(HID, HID)
            self.hh = nn.Linear(HID, HID)

        def forward(self, x, h, scale=None):
            h2 = paddle_.tanh(self.ih(x) + self.hh(h))
            if scale is not None:
                h2 = h2 * scale
            return h2, h2

    class Model(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, HID)
            self.cell = Cell()
            self.out = nn.Linear(HID, V)

    return Model()


def _tied(model):
    sd = state_arrays(model)
    sd["out.weight"][:, 4] = sd["out.weight"][:, 3]
    sd["out.bias"][3] += 1.0            # the tied pair among the best
    sd["out.bias"][4] = sd["out.bias"][3]
    sd["out.bias"][EOS] += 1.5          # the end token fires early
    return sd


@pytest.mark.parametrize("beam", [1, BEAM])
def test_beam_search_matches_jax_with_ties_and_end_token(beam):
    pt.seed(5)
    tm = tiny_decoder(pt)
    sd = _tied(tm)
    tm.set_state_dict(sd)
    jm = tiny_decoder(paddle)
    jm.set_state_dict(sd)
    h0 = np.random.default_rng(6).standard_normal((4, HID)).astype(
        np.float32)
    outs = []
    for pk, m, conv in ((pt, tm, torch.from_numpy),
                        (paddle, jm, paddle.to_tensor)):
        dec = pk.nn.BeamSearchDecoder(m.cell, 0, EOS, beam,
                                      embedding_fn=m.emb, output_fn=m.out)
        with pk.no_grad():
            out, _, lengths = pk.nn.dynamic_decode(
                dec, inits=conv(h0), max_step_num=12, return_length=True,
                scale=conv(np.array(0.9, np.float32)))
        outs.append([_np(out.predicted_ids), _np(out.parent_ids),
                     _np(out.scores), _np(lengths)])
    (p, par, sc, ln), (jp, jpar, jsc, jln) = outs
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(par, jpar)
    np.testing.assert_array_equal(ln, jln)
    np.testing.assert_allclose(sc, jsc, rtol=1e-5, atol=1e-5)
    assert (p == EOS).any()                         # the end token fired
    assert p.shape[1] < 12 or (ln < 12).any()


def test_gather_tree_and_tile_match_jax():
    r = np.random.default_rng(8)
    ids = r.integers(0, 7, (6, 2, 3)).astype(np.int64)
    par = r.integers(0, 3, (6, 2, 3)).astype(np.int64)
    got = pt.nn.functional.gather_tree(torch.from_numpy(ids),
                                       torch.from_numpy(par))
    want = paddle.nn.functional.gather_tree(paddle.to_tensor(ids),
                                            paddle.to_tensor(par))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), cs.np_backtrace(ids, par))
    x = r.standard_normal((2, 3)).astype(np.float32)
    dec = pt.nn.BeamSearchDecoder(None, 0, 1, 4)
    jdec = paddle.nn.BeamSearchDecoder(None, 0, 1, 4)
    np.testing.assert_array_equal(
        dec.tile_beam_merge_with_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jdec.tile_beam_merge_with_batch(paddle.to_tensor(x))))
