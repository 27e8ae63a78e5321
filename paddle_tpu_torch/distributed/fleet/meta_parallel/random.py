"""Model-parallel RNG state tracking. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/random.py``
(``RNGStatesTracker``, ``get_rng_state_tracker``,
``model_parallel_random_seed``).

The tracker keeps one named ``torch.Generator`` per region, on the
device the framework runs on when the region is added (the rank's
device after ``init_parallel_env``); ``rng_state(name)``
swaps it in as that device's framework generator for the block
(``framework.random_seed.swap_generator``), so dropout inside draws from
the named stream, and swaps the advanced stream back out after it. Draws
outside such a block come from the framework's generator, which every
rank seeds alike: tp-replicated regions draw the same masks on every tp
rank as long as they draw in the same order.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ....framework import random_seed
from ....framework.device import resolve_device

__all__ = ["MODEL_PARALLEL_RNG", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        """Add the stream ``name`` seeded with ``seed`` on the framework's
        device."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        g = torch.Generator(device=resolve_device())
        g.manual_seed(int(seed))
        self.states_[name] = g

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        prev = random_seed.swap_generator(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = random_seed.swap_generator(prev)


RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the tracker's model-parallel stream with ``seed * 1024 +
    mp_rank * 100`` and the framework's generators with ``seed`` (a
    random pair of seeds, distinct per mp rank, when ``seed`` is None)."""
    from ... import fleet

    rank = fleet.get_hybrid_communicate_group().get_model_parallel_rank()
    if seed:
        global_seed = seed
        local_seed = seed * 1024 + rank * 100
    else:
        global_seed = int(np.random.randint(0, 655350))
        local_seed = int(np.random.randint(rank * 10000 + 1,
                                           (rank + 1) * 10000))
    RNG_STATE_TRACKER.reset()
    RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
    random_seed.seed(global_seed)
