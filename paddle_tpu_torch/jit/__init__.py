"""``jit``: not in the port yet.

The JAX package's ``jit.save`` exports a model (a quantized one included)
for its inference predictor; that round trip comes with the port's long
tail (ROADMAP.md, port queue item 9). Until then ``save`` raises.
"""
from __future__ import annotations

__all__ = ["save"]


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(
        "jit.save and the inference-predictor round trip (of a quantized "
        "model too) are not in the port yet (ROADMAP.md, port queue item "
        "9: long tail)")
