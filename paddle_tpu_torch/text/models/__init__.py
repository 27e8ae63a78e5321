from .bert import (BERT_BASE, BERT_LARGE, BERT_TINY, BertConfig,
                   BertForPretraining, BertForSequenceClassification,
                   BertModel)
from .ernie_moe import (ERNIE_MOE_TINY, ErnieMoEConfig, ErnieMoEForPretraining,
                        ErnieMoEModel)
from .gpt import GPT_TINY, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LLAMA2_7B, LLAMA2_13B, LLAMA_TINY, LlamaConfig,
                    LlamaForCausalLM)
from .llama_pipe import LlamaForCausalLMPipe
from .t5 import T5_TINY, T5Config, T5ForConditionalGeneration, T5Model
from . import convert

__all__ = ["BERT_BASE", "BERT_LARGE", "BERT_TINY", "BertConfig",
           "BertForPretraining", "BertForSequenceClassification",
           "BertModel", "ERNIE_MOE_TINY", "ErnieMoEConfig",
           "ErnieMoEForPretraining", "ErnieMoEModel", "GPT_TINY",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "LLAMA2_7B",
           "LLAMA2_13B", "LLAMA_TINY", "LlamaConfig", "LlamaForCausalLM",
           "LlamaForCausalLMPipe", "T5_TINY", "T5Config",
           "T5ForConditionalGeneration", "T5Model", "convert"]
