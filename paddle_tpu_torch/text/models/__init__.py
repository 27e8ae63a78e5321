from .ernie_moe import (ERNIE_MOE_TINY, ErnieMoEConfig, ErnieMoEForPretraining,
                        ErnieMoEModel)
from .gpt import GPT_TINY, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LLAMA2_7B, LLAMA2_13B, LLAMA_TINY, LlamaConfig,
                    LlamaForCausalLM)
from .llama_pipe import LlamaForCausalLMPipe

__all__ = ["ERNIE_MOE_TINY", "ErnieMoEConfig", "ErnieMoEForPretraining",
           "ErnieMoEModel", "GPT_TINY", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "LLAMA2_7B", "LLAMA2_13B", "LLAMA_TINY",
           "LlamaConfig", "LlamaForCausalLM", "LlamaForCausalLMPipe"]
