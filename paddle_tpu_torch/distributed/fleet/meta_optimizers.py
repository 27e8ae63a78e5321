"""Fleet's optimizer wrappers. Counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers.py`` (only
``HybridParallelGradScaler`` so far)."""
from __future__ import annotations

__all__ = ["HybridParallelGradScaler"]


class HybridParallelGradScaler:
    """``dygraph_optimizer/hybrid_parallel_gradscaler.py``: delegates to
    the wrapped scaler. The train step agrees ``found_inf`` over every
    rank itself (``TrainStep``), so there is nothing to add."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, name):
        return getattr(self._scaler, name)
