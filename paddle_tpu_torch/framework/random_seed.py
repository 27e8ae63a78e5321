"""Seeding for parameter initialisation and dropout.

Counterpart of ``paddle_tpu/framework/random_seed.py``. ``seed(n)``
(paddle.seed) resets one ``torch.Generator`` per device; parameter
initialisers and ``nn.functional.dropout`` draw from
``generator(device)``, so a model built twice after the same ``seed`` has
the same weights and the same dropout masks. The numbers differ from the JAX
package's for the same seed (threefry vs Philox/mt19937): tests carry
weights across with ``framework.io.load_numpy_state_dict`` instead.

``swap_generator(g)`` installs ``g`` as its device's generator and returns
the one it replaces (``random_seed.swap_key``'s counterpart): the
model-parallel RNG tracker swaps a named stream in for a block.
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


def swap_generator(g: torch.Generator) -> torch.Generator:
    """Install ``g`` as the generator of its device; return the previous
    one (created from the current seed when the device had none)."""
    prev = generator(g.device)
    _generators[str(prev.device)] = g
    return prev
