"""Model-parallel and pipeline layers. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``; the RNG tracker
(``random.py``) comes with ERNIE-MoE under tp (ROADMAP.md, port queue
item 4)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc"]
