from .ernie_moe import (ERNIE_MOE_TINY, ErnieMoEConfig, ErnieMoEForPretraining,
                        ErnieMoEModel)
from .llama import (LLAMA2_7B, LLAMA2_13B, LLAMA_TINY, LlamaConfig,
                    LlamaForCausalLM)

__all__ = ["ERNIE_MOE_TINY", "ErnieMoEConfig", "ErnieMoEForPretraining",
           "ErnieMoEModel", "LLAMA2_7B", "LLAMA2_13B", "LLAMA_TINY",
           "LlamaConfig", "LlamaForCausalLM"]
