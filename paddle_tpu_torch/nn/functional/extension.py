"""Extension functionals. Counterpart of
``paddle_tpu/nn/functional/extension.py``: ``diag_embed``,
``sequence_mask``, ``gather_tree`` and ``temporal_shift``
(``class_center_sample`` is queued: ROADMAP.md, Queue 1 item 9 part A).

``sequence_mask`` without ``maxlen`` reads the longest length to the
host, as the JAX package does. ``gather_tree`` walks the parent pointers
back from the last step, one gather a step.
"""
from __future__ import annotations

import torch

from ...framework.dtype import convert_dtype
from ...tensor_ops.creation import diag_embed as _diag_embed

__all__ = ["diag_embed", "gather_tree", "sequence_mask", "temporal_shift"]


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last axis of ``input`` as the (dim1, dim2) diagonal."""
    return _diag_embed(input, offset, dim1, dim2)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths ``[...]`` -> 0/1 mask ``[..., maxlen]``."""
    if maxlen is None:
        maxlen = int(x.max())
    return (torch.arange(int(maxlen), device=x.device) < x[..., None]).to(
        convert_dtype(dtype))


def gather_tree(ids, parents):
    """Back-trace beam-search ``ids [T, B, beam]`` along ``parents``: the
    token sequences that end in each final beam."""
    t_max = ids.shape[0]
    parent = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    parents = parents.long()
    outs = []
    for t in range(t_max - 1, -1, -1):
        outs.append(ids[t].gather(-1, parent))
        parent = parents[t].gather(-1, parent)
    return torch.stack(outs[::-1])


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: the first ``C * shift_ratio`` channels move one step back in
    time, the next as many one step forward, ``x [N * T, C, H, W]``."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError("data_format must be NCHW or NHWC")
    a = torch.movedim(x, -1, 1) if data_format == "NHWC" else x
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.nn.functional.pad(v[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    fwd = torch.nn.functional.pad(v[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return torch.movedim(out, 1, -1) if data_format == "NHWC" else out
