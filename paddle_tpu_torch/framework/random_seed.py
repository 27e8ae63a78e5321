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

``get_rng_state()`` / ``set_rng_state()`` are the counterpart of the JAX
package's key chain (``random_seed.get_rng_state``): the seed, the state
of every device generator that exists, and the named streams of
``fleet.meta_parallel``'s ``RNGStatesTracker``, as a nested dict of CPU
tensors, so a resumed run draws the same dropout masks.
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


def _tracker():
    from ..distributed.fleet.meta_parallel.random import RNG_STATE_TRACKER
    return RNG_STATE_TRACKER


def get_rng_state() -> dict:
    """The seed and every generator's state (device generators by device,
    the RNG tracker's streams by name), as copies."""
    return {"seed": torch.tensor(_seed_value, dtype=torch.int64),
            "generators": {k: g.get_state() for k, g in _generators.items()},
            "tracker": {k: g.get_state()
                        for k, g in _tracker().states_.items()}}


def set_rng_state(state: dict) -> None:
    """Restore a ``get_rng_state()``: the seed, the device generators it
    holds (the others start afresh from the seed on first use, as they
    would have), and the tracker streams it names."""
    global _seed_value

    def byte_state(t):
        return torch.as_tensor(t).detach().to("cpu", torch.uint8).clone()

    _seed_value = int(state["seed"])
    _generators.clear()
    for k, st in state.get("generators", {}).items():
        generator(k).set_state(byte_state(st))
    tracker = _tracker()
    for k, st in state.get("tracker", {}).items():
        g = tracker.states_.get(k)
        if g is None:
            from .device import resolve_device
            g = tracker.states_[k] = torch.Generator(device=resolve_device())
        g.set_state(byte_state(st))
