"""Three-level RNG discipline for tensor parallel (counterpart of
``paddlepaddle_tpu/distributed/fleet/random.py``; reference:
python/paddle/distributed/fleet/layers/mpu/random.py — RNGStatesTracker,
get_rng_state_tracker, model_parallel_rng regions).

Under TP, dropout INSIDE parallel regions must differ per mp shard while
dropout outside must be identical. Each tracked state is a
:class:`~...core.random.Generator`: a seed and an explicit
``torch.Generator`` per device; ``rng_state(name)`` routes the port's
random ops (the attention dropouts) to that state's generators
(``core.random.generator_scope``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

from ...core import random as prandom

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, prandom.Generator] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = prandom.Generator(seed)

    def get_states_tracker(self):
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        for n, s in states.items():
            self.states_.setdefault(n, prandom.Generator(0)).set_state(s)

    @contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        with prandom.generator_scope(self.states_[name]):
            yield


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the global and the model-parallel generators (reference
    random.py: the local seed is the base + 1024; the JAX package keeps no
    per-mp-rank offset, and neither does the port, so the two named
    streams match its seeds)."""
    import random as pyrandom

    seed = seed if seed is not None else pyrandom.randint(0, 2**31 - 1)
    global_seed = seed
    local_seed = seed + 1024
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add(MODEL_PARALLEL_RNG, local_seed)
    prandom.seed(global_seed)
    return global_seed, local_seed
