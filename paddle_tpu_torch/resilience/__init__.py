"""Fault tolerance (PyTorch port of ``paddle_tpu.resilience``): what the
serving supervisor and the replica fleet use.

* :class:`ChaosMonkey` -- deterministic seeded fault injection, the JAX
  package's plans and draws; the serving and fleet faults, and the
  training ones except checkpoint corruption.
* :class:`FlightLedger` -- a bounded black-box JSONL recorder.
* :class:`StepTimeout` -- a supervised step past its deadline.

The training ``Supervisor``, ``TrainState``, ``ResumableLoader`` and
checkpoint corruption wait for the port's checkpoint (ROADMAP.md, port
queue item 7: training robustness).
"""
from .chaos import (FAULTS, FLEET_FAULTS, SERVING_FAULTS, ChaosError,
                    ChaosMonkey, StallInjected, corrupt_checkpoint,
                    corrupt_kv, corrupt_latest)
from .ledger import FlightLedger, global_counters
from .supervisor import StepTimeout

__all__ = ["StepTimeout", "ChaosMonkey", "ChaosError", "StallInjected",
           "FAULTS", "SERVING_FAULTS", "FLEET_FAULTS", "corrupt_checkpoint",
           "corrupt_kv", "corrupt_latest", "FlightLedger",
           "global_counters"]
