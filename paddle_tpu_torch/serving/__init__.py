"""Continuous-batching serving (PyTorch port of ``paddle_tpu.serving``;
Llama and GPT, greedy or sampled, paged or slot KV layout, chunked
prefill, tensor parallel over ranks, speculative decoding)."""
from .engine import (DEFAULT_RETRY_AFTER_S, Engine, EngineOverloaded,
                     RequestCancelled, RequestHandle, RequestTimeout)
from .kv_cache import (TRASH_BLOCK, BlockPool, PagedKVCache, RadixIndex,
                       SlotKVCache)
from .metrics import EngineMetrics, RequestMetrics, ledger
from .scheduler import FIFOScheduler, PriorityScheduler
from .speculative import SpecConfig

__all__ = ["DEFAULT_RETRY_AFTER_S", "Engine", "EngineOverloaded",
           "RequestCancelled", "RequestHandle", "RequestTimeout",
           "TRASH_BLOCK", "BlockPool", "PagedKVCache", "RadixIndex",
           "SlotKVCache",
           "EngineMetrics", "RequestMetrics", "ledger", "FIFOScheduler",
           "PriorityScheduler", "SpecConfig"]
