"""Distributed training. Counterpart of ``paddle_tpu/distributed``; this
slice of the port has ``fleet``'s world-size-1 train step. Meshes,
collectives and every parallel degree > 1 come with the multi-GPU slice
(ROADMAP.md, port queue item 4)."""
from . import fleet

__all__ = ["fleet"]
