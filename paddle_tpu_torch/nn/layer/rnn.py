"""Recurrent layers. Counterpart of ``paddle_tpu/nn/layer/rnn.py``:
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``, ``BiRNN`` and the
multi-layer ``SimpleRNN``, ``LSTM`` and ``GRU``.

A cell's weights are ``weight_ih [gates * hidden, in]``, ``weight_hh
[gates * hidden, hidden]`` and the biases ``bias_ih``/``bias_hh``, all
``Uniform(+-1 / sqrt(hidden))``, in the JAX package's gate orders: LSTM
(i, f, g, o), GRU (r, z, n) with ``h' = (1 - z) n + z h`` and the reset
gate applied to the recurrent half (``n = tanh(x_n + r (W_hn h + b_hn))``).

``RNN`` runs its cell over time in a Python loop, one cell call a step
(the JAX package's ``lax.scan``), so any ``RNNCellBase`` subclass runs
in it; every product is a cuBLAS matmul (fp32 with TF32 off, the port's
default), no cuDNN RNN. Layouts are ``[batch, time, feature]``, or
``[time, batch, feature]`` with ``time_major``. The multi-layer layers
stack their final states ``[layers * directions, batch, hidden]``
(an LSTM's h and c apart) and apply ``dropout`` between layers in
training.

``BiRNN`` holds each cell once, inside ``rnn_fw``/``rnn_bw``;
``cell_fw``/``cell_bw`` read them there, so the ``state_dict`` lists
``rnn_fw.cell.*`` alone, as the JAX package's does.

``sequence_length`` is not taken: the JAX package accepts it and ignores
it, so the port raises rather than compute what a caller did not ask for
(ROADMAP.md, Queue 3, "Divergences kept on purpose").
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from ..layer_base import Layer
from ..param_attr import make_parameter
from .container import LayerList

__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell"]


def _no_sequence_length(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            "sequence_length is not taken: the JAX package ignores it, so "
            "the port raises rather than run past the lengths (ROADMAP.md, "
            "Queue 3, divergences kept on purpose)")


class RNNCellBase(Layer):
    """A cell: ``forward(inputs, states) -> (outputs, new_states)``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value``, ``[batch, *state_shape]`` each (batch
        from ``batch_ref.shape[batch_dim_idx]``), float32 unless
        ``dtype`` says otherwise, on ``batch_ref``'s device."""
        from ...framework.dtype import convert_dtype
        b = batch_ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype) or torch.float32

        def full(s):
            return torch.full((b,) + tuple(s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(self.state_shape[0], (list, tuple)):
            return tuple(full(s) for s in self.state_shape)
        return full(self.state_shape)


def _cell_params(layer, input_size, hidden_size, gates, attrs, device,
                 dtype):
    if hidden_size <= 0:
        raise ValueError(
            f"hidden_size of {type(layer).__name__} must be greater "
            f"than 0, but now equals to {hidden_size}")
    k = 1.0 / math.sqrt(hidden_size)
    init = Uniform(-k, k)
    shapes = {"weight_ih": (gates * hidden_size, input_size),
              "weight_hh": (gates * hidden_size, hidden_size),
              "bias_ih": (gates * hidden_size,),
              "bias_hh": (gates * hidden_size,)}
    for name, shape in shapes.items():
        setattr(layer, name, make_parameter(shape, attrs[name], dtype,
                                            name.startswith("bias"), init,
                                            device))


def _gates(x, h, cell):
    xg = x @ cell.weight_ih.T
    if cell.bias_ih is not None:
        xg = xg + cell.bias_ih
    hg = h @ cell.weight_hh.T
    if cell.bias_hh is not None:
        hg = hg + cell.bias_hh
    return xg, hg


class _Cell(RNNCellBase):
    _gate_count = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.input_size = input_size
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, self._gate_count,
                     dict(weight_ih=weight_ih_attr, weight_hh=weight_hh_attr,
                          bias_ih=bias_ih_attr, bias_hh=bias_hh_attr),
                     device, dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_Cell):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype="float32"):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, dtype=dtype)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        xg, hg = _gates(inputs, states, self)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(xg + hg)
        return h, h


class LSTMCell(_Cell):
    _gate_count = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        xg, hg = _gates(inputs, h, self)
        i, f, g, o = (xg + hg).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class GRUCell(_Cell):
    _gate_count = 3

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        xg, hg = _gates(inputs, states, self)
        xr, xz, xn = xg.chunk(3, dim=-1)
        hr, hz, hn = hg.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * states
        return h, h


class RNN(Layer):
    """Runs ``cell`` over the time axis (reversed with ``is_reverse``);
    returns (outputs stacked on the time axis, the final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        _no_sequence_length(sequence_length)
        t_axis = 0 if self.time_major else 1
        states = initial_states
        if states is None:
            states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 - t_axis)
        steps = range(inputs.shape[t_axis])
        outs = []
        for t in (reversed(steps) if self.is_reverse else steps):
            out, states = self.cell(inputs.select(t_axis, t), states,
                                    **kwargs)
            outs.append(out)
        if self.is_reverse:
            outs.reverse()
        return torch.stack(outs, dim=t_axis), states


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` backward over time, outputs
    concatenated on the feature axis; states (forward's, backward's)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    @property
    def cell_fw(self):
        return self.rnn_fw.cell

    @property
    def cell_bw(self):
        return self.rnn_bw.cell

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        _no_sequence_length(sequence_length)
        states = initial_states or (None, None)
        out_f, st_f = self.rnn_fw(inputs, states[0], **kwargs)
        out_b, st_b = self.rnn_bw(inputs, states[1], **kwargs)
        return torch.cat([out_f, out_b], dim=-1), (st_f, st_b)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", device=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.mode = mode
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.hidden_size = hidden_size
        bidir = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidir else 1

        def make_cell(in_sz):
            kw = dict(device=device, dtype=dtype)
            if mode == "LSTM":
                return LSTMCell(in_sz, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(in_sz, hidden_size, **kw)
            return SimpleRNNCell(in_sz, hidden_size, activation, **kw)

        self.rnns = LayerList()
        for i in range(num_layers):
            in_sz = input_size if i == 0 else hidden_size * \
                self.num_directions
            self.rnns.append(
                BiRNN(make_cell(in_sz), make_cell(in_sz), time_major)
                if bidir else RNN(make_cell(in_sz), False, time_major))

    def __iter__(self):
        return iter(self.rnns)

    def __len__(self):
        return len(self.rnns)

    def __getitem__(self, i):
        return self.rnns[i]

    def _layer_states(self, initial_states, i):
        """Layer i's part of the ``[L * D, B, H]`` initial states."""
        if initial_states is None:
            return None
        if self.mode == "LSTM":
            h, c = initial_states
            if self.num_directions == 1:
                return (h[i], c[i])
            return ((h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1]))
        if self.num_directions == 1:
            return initial_states[i]
        return (initial_states[2 * i], initial_states[2 * i + 1])

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        out = inputs
        finals = []
        for i, rnn in enumerate(self.rnns):
            out, fs = rnn(out, self._layer_states(initial_states, i))
            finals.append(fs if self.num_directions == 2 else (fs,))
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        per = [s for layer in finals for s in layer]     # layer-major, fw/bw
        if self.mode == "LSTM":
            return out, (torch.stack([s[0] for s in per]),
                         torch.stack([s[1] for s in per]))
        return out, torch.stack(per)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, dtype="float32",
                 **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, device,
                         dtype)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, dtype="float32", **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, dtype="float32", **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         dtype=dtype)
