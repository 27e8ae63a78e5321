"""Seq2seq decoding: ``Decoder``, ``BeamSearchDecoder`` and
``dynamic_decode``. Counterpart of ``paddle_tpu/nn/layer/decode.py``.

Each step is static-shaped (``[batch * beam, ...]``) and runs on the
device; the loop runs on the host and stops when every beam has
finished (one device-to-host read a step) or after ``max_step_num``
steps (256 by default). A finished beam extends only with ``end_token``
at no cost (every other token at -1e9), a dead beam starts at -1e9, and
the top ``beam_size`` of ``beam * vocab`` candidates come from a stable
descending sort, so ties go to the lower index as with
``jax.lax.top_k``. ``finalize`` backtraces with ``gather_tree``. Extra
keyword arguments of ``dynamic_decode`` reach the cell at every step
(an attention decoder's encoder outputs).
"""
from __future__ import annotations

import collections

import torch

from ..functional.extension import gather_tree

__all__ = ["BeamSearchDecoder", "Decoder", "dynamic_decode"]


class Decoder:
    """``initialize`` / ``step`` / ``finalize``, as paddle's."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def _map_structure(fn, obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_structure(fn, o) for o in obj)
    return fn(obj)


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell: ``cell(inputs, states, **kwargs)``
    with the inputs ``embedding_fn(tokens)`` and the logits
    ``output_fn(cell outputs)``."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _split(self, x, batch):
        return x.reshape((batch, self.beam_size) + tuple(x.shape[1:]))

    def tile_beam_merge_with_batch(self, x):
        """``[B, ...]`` -> ``[B * beam, ...]``, each row ``beam`` times."""
        return torch.repeat_interleave(x, self.beam_size, dim=0)

    def initialize(self, initial_cell_states):
        cell_states = _map_structure(self.tile_beam_merge_with_batch,
                                     initial_cell_states)
        probe = (cell_states[0] if isinstance(cell_states, (list, tuple))
                 else cell_states)
        batch = probe.shape[0] // self.beam_size
        dev = probe.device
        log_probs = torch.tensor([0.0] + [-1e9] * (self.beam_size - 1),
                                 dtype=torch.float32, device=dev).repeat(
                                     batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int64,
                              device=dev)
        inputs = torch.full((batch * self.beam_size,), self.start_token,
                            dtype=torch.int64, device=dev)
        return (inputs, self.StateWrapper(cell_states, log_probs, finished,
                                          lengths), finished)

    def step(self, time, inputs, states, **kwargs):
        batch = states.log_probs.shape[0]
        cell_inputs = (self.embedding_fn(inputs) if self.embedding_fn
                       is not None else inputs)
        cell_out, next_cell_states = self.cell(cell_inputs,
                                               states.cell_states, **kwargs)
        logits = (self.output_fn(cell_out) if self.output_fn is not None
                  else cell_out)
        vocab = logits.shape[-1]
        step_lp = self._split(torch.log_softmax(logits, dim=-1), batch)
        is_end = torch.arange(vocab, device=logits.device) == self.end_token
        step_lp = torch.where(states.finished[..., None],
                              torch.where(is_end, 0.0, -1e9), step_lp)
        total = (states.log_probs[..., None] + step_lp).reshape(batch, -1)
        scores, idx = torch.sort(total, dim=-1, descending=True, stable=True)
        scores, idx = scores[:, :self.beam_size], idx[:, :self.beam_size]
        parent = torch.div(idx, vocab, rounding_mode="floor")
        token = idx % vocab

        def pick_parent(s):
            s = self._split(s, batch)
            ix = parent.reshape(parent.shape + (1,) * (s.dim() - 2))
            out = s.gather(1, ix.expand((batch, self.beam_size)
                                        + tuple(s.shape[2:])))
            return out.reshape((-1,) + tuple(s.shape[2:]))

        next_cells = _map_structure(pick_parent, next_cell_states)
        prev_fin = states.finished.gather(1, parent)
        prev_len = states.lengths.gather(1, parent)
        now_fin = prev_fin | (token == self.end_token)
        lengths = torch.where(prev_fin, prev_len, prev_len + 1)
        next_state = self.StateWrapper(next_cells, scores, now_fin, lengths)
        return (self.OutputWrapper(scores, token, parent), next_state,
                token.reshape(-1), now_fin)

    def finalize(self, outputs, final_states, sequence_lengths):
        preds = gather_tree(outputs.predicted_ids, outputs.parent_ids)
        return self.OutputWrapper(outputs.scores, preds,
                                  outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam finishes or ``max_step_num``
    steps (256 by default). Returns (outputs ``[B, T, ...]``, or ``[T, B,
    ...]`` with ``output_time_major``, the final states), and the lengths
    with ``return_length``."""
    inputs, states, finished = decoder.initialize(inits)
    outs = []
    max_steps = max_step_num if max_step_num is not None else 256
    while len(outs) < max_steps:
        out, states, inputs, finished = decoder.step(len(outs), inputs,
                                                     states, **kwargs)
        outs.append(out)
        if bool(finished.all()):
            break
    stacked = type(outs[0])(*[torch.stack([getattr(o, f) for o in outs])
                              for f in outs[0]._fields])
    final_out, final_states = decoder.finalize(
        stacked, states, getattr(states, "lengths", None))
    if not output_time_major:
        final_out = type(final_out)(*[f.movedim(0, 1) if f.dim() >= 2
                                      else f for f in final_out])
    if return_length:
        return final_out, final_states, states.lengths
    return final_out, final_states
