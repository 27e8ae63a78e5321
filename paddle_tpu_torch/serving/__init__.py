"""Continuous-batching serving (PyTorch port of ``paddle_tpu.serving``;
Llama and GPT, greedy or sampled, paged or slot KV layout, chunked
prefill, tensor parallel over ranks, speculative decoding).

Deployment goes one way: ``save_lm(model, path)`` writes a servable
artifact, ``paddle_tpu_torch.inference.create_llm_predictor(path)``
rebuilds the model from it and serves it through an ``Engine``. In
production the engine is wrapped in an ``EngineSupervisor``
(``resilience.py``: a wedged or crashed decode step rebuilds the engine
and replays the requests in flight token-identically; overload degrades
through priority/EDF admission, brownout shedding and ``drain()``), and a
``ReplicaFleet`` (``fleet.py``) puts several supervised replicas behind
one prefix-aware router that migrates requests off a faulted replica.
Both run under tensor parallelism too, every rank in lockstep: the
supervisor over ``Engine(tp=N)``, the fleet with mixed tp degrees.
"""
from .engine import (DEFAULT_RETRY_AFTER_S, AdoptMismatch, Engine,
                     EngineOverloaded, RequestCancelled, RequestHandle,
                     RequestShed, RequestTimeout)
from .fleet import REPLICA_STATES, ReplicaFleet
from .kv_cache import (TRASH_BLOCK, BlockPool, PagedKVCache, RadixIndex,
                       SlotKVCache)
from .metrics import EngineMetrics, RequestMetrics, ledger
from .resilience import EngineDraining, EngineSupervisor, ServingAborted
from .scheduler import FIFOScheduler, PriorityScheduler
from .speculative import SpecConfig

__all__ = ["Engine", "RequestHandle", "RequestTimeout", "RequestShed",
           "RequestCancelled", "AdoptMismatch", "SlotKVCache",
           "PagedKVCache", "BlockPool",
           "RadixIndex", "EngineMetrics",
           "RequestMetrics", "ledger", "EngineOverloaded", "FIFOScheduler",
           "PriorityScheduler", "EngineSupervisor", "ServingAborted",
           "EngineDraining", "ReplicaFleet", "REPLICA_STATES", "save_lm",
           "SpecConfig", "DEFAULT_RETRY_AFTER_S", "TRASH_BLOCK"]


def save_lm(model, path, precompile=None, n_slots=8, max_len=None,
            buckets=None, **engine_kwargs):
    """Save a ``LlamaForCausalLM`` or ``GPTForCausalLM`` as a servable
    artifact: ``jit.save``'s weights plus ``llm_arch`` and ``llm_config``
    (``dataclasses.asdict(model.config)``), so
    ``inference.create_llm_predictor`` can rebuild the model and serve it
    without the code that built it. The artifact is the JAX package's
    format: an fp32 one is read by either package. Returns the artifact's
    path (``<path>.pdmodel``).

    ``precompile=True`` (or ``PADDLE_TPU_AOT_PRECOMPILE=1``) asks the JAX
    package's engine to ship its compiled programs with the artifact; the
    port has no programs to ship, and raises ``NotImplementedError``
    before anything is written (ROADMAP.md, port queue: runtime
    services), where the JAX package would warn and carry on. ``n_slots``,
    ``max_len``, ``buckets`` and ``engine_kwargs`` pin that geometry and
    are unused without it."""
    import dataclasses
    import os

    from ..jit.serialization import save
    from ..text.generation import arch_for
    from .engine import _not_in_slice

    arch = arch_for(model)          # validates the model type
    if precompile is None:
        precompile = os.environ.get("PADDLE_TPU_AOT_PRECOMPILE",
                                    "0") == "1"
    if precompile:
        raise _not_in_slice("AOT program handles (save_lm precompile)",
                            "runtime services")
    cfg = dataclasses.asdict(model.config)
    if arch.name == "gpt" and cfg.get("dtype") == "float32":
        # the JAX GPTConfig has no dtype field (its GPT is fp32 only):
        # an fp32 artifact leaves the port's field out, so JAX reads it
        cfg.pop("dtype")
    return save(model, path, llm_arch=arch.name, llm_config=cfg)
