"""Fault tolerance (PyTorch port of ``paddle_tpu.resilience``): a
training loop, and the serving supervisor and replica fleet, that survive
the failures we actually hit.

* :class:`Supervisor` -- escalation ladder around any train step:
  skip non-finite -> retry wedged -> roll back to a durable checkpoint ->
  abort with a post-mortem; cadence + emergency checkpointing; exact
  (bitwise) preemption resume via :meth:`Supervisor.resume`.
* :class:`TrainState` / :class:`ResumableLoader` -- the snapshot surface:
  params, optimizer moments, RNG generators, AMP loss scaler, dataloader
  position.
* :class:`ChaosMonkey` -- deterministic seeded fault injection (NaN,
  stall, error, SIGKILL, checkpoint corruption; the serving and fleet
  faults) so every recovery path is exercised by test, not by luck. CLI:
  ``tools/torch_chaos_train.py``, ``tools/torch_chaos_serve.py``.
* :class:`FlightLedger` -- a bounded black-box JSONL recorder.
"""
from .chaos import (FAULTS, FLEET_FAULTS, SERVING_FAULTS, ChaosError,
                    ChaosMonkey, StallInjected, corrupt_checkpoint,
                    corrupt_kv, corrupt_latest)
from .ledger import FlightLedger, global_counters
from .supervisor import (ResumableLoader, StepTimeout, Supervisor,
                         SupervisorAborted, TrainState)

__all__ = [
    "Supervisor", "SupervisorAborted", "StepTimeout", "TrainState",
    "ResumableLoader", "ChaosMonkey", "ChaosError", "StallInjected",
    "FAULTS", "SERVING_FAULTS", "FLEET_FAULTS", "corrupt_checkpoint",
    "corrupt_kv",
    "corrupt_latest", "FlightLedger", "global_counters",
]
