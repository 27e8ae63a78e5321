"""Model-parallel layers. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``; the pipeline layers and
the RNG tracker come with the pipeline slice (ROADMAP.md, port queue
item 4)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding"]
