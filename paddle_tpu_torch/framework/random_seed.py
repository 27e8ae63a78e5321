"""Seeding for parameter initialisation and dropout.

Counterpart of ``paddle_tpu/framework/random_seed.py``. ``seed(n)``
(paddle.seed) resets one ``torch.Generator`` per device; parameter
initialisers and ``nn.functional.dropout`` draw from
``generator(device)``, so a model built twice after the same ``seed`` has
the same weights and the same dropout masks. The numbers differ from the JAX
package's for the same seed (threefry vs Philox/mt19937): tests carry
weights across with ``framework.io.load_numpy_state_dict`` instead.
"""
from __future__ import annotations

import torch

_seed_value = 0
_generators: dict = {}


def seed(value: int) -> int:
    """Seed every device's initialisation generator."""
    global _seed_value
    _seed_value = int(value)
    _generators.clear()
    return _seed_value


def generator(device) -> torch.Generator:
    """The generator of ``device`` (created on first use from the current
    seed)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed_value)
        _generators[key] = g
    return g
