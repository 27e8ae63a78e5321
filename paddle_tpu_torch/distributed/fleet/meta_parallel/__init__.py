"""Model-parallel and pipeline layers, and the model-parallel RNG
tracker. Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel``."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed"]
