"""Seeded random streams of the port.

Counterpart of ``paddlepaddle_tpu/core/random.py`` (:21-125): ``paddle.seed``,
a default generator, named generators (the tensor-parallel RNG tracker's
streams), ``get_rng_state`` / ``set_rng_state``, a ``generator_scope``
that routes draws to another generator, and ``capture`` / ``replay``, which
activation recompute uses to draw a recomputed dropout's mask again.

PyTorch idiom, not a copy of the JAX key splitting: a :class:`Generator`
holds one ``torch.Generator`` per device, each seeded with the generator's
seed when it is first asked for, and the port's random ops (the attention
dropouts) draw from ``torch_generator(device)``. The draws are not bit-equal
to the JAX package's from the same seed; what carries over is that a seed
reproduces them and that they do not follow torch's global stream. The JAX
``key_scope`` (a traced key under ``jit``) has no counterpart: the port runs
eagerly.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def _device_key(device: DeviceLike) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class Generator:
    """One seed and, per device, the ``torch.Generator`` that draws from it."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[str, torch.Generator] = {}

    def manual_seed(self, seed: int) -> "Generator":
        self._seed = int(seed)
        for gen in self._gens.values():
            gen.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device: DeviceLike = "cpu") -> torch.Generator:
        """The stream for ``device``, created at first use from the seed."""
        key = _device_key(device)
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(self._seed)
            self._gens[key] = gen
        return gen

    def get_state(self) -> dict:
        return {"seed": self._seed,
                "states": {k: g.get_state() for k, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._gens = {}
        for key, st in state.get("states", {}).items():
            self.torch_generator(key).set_state(st)


_default_generator = Generator(0)
_named_generators: Dict[str, Generator] = {}
_scope_stack: List[Generator] = []      # innermost generator_scope wins


@contextmanager
def generator_scope(gen: Generator):
    """Route unnamed draws to ``gen`` (the mpu RNG tracker's mechanism: a
    named generator temporarily replaces the default stream)."""
    _scope_stack.append(gen)
    try:
        yield gen
    finally:
        _scope_stack.pop()


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """``paddle.seed``: reseeds the default generator and, as the JAX
    package does, the i-th named generator with ``s + i + 1``."""
    _default_generator.manual_seed(s)
    for i, g in enumerate(_named_generators.values()):
        g.manual_seed(s + i + 1)
    return _default_generator


def get_generator(name: Optional[str] = None) -> Generator:
    if name is None:
        return _default_generator
    if name not in _named_generators:
        _named_generators[name] = Generator(
            _default_generator.initial_seed() + len(_named_generators) + 1)
    return _named_generators[name]


def torch_generator(device: DeviceLike = "cpu",
                    name: Optional[str] = None) -> torch.Generator:
    """The ``torch.Generator`` a random op on ``device`` draws from: the
    innermost :func:`generator_scope`'s for an unnamed draw, else the named
    (or default) generator's."""
    if _scope_stack and name is None:
        return _scope_stack[-1].torch_generator(device)
    return get_generator(name).torch_generator(device)


def dropout_generator(device: DeviceLike, fixed_seed_offset=None,
                      rng_name: str = "") -> torch.Generator:
    """The stream an attention dropout draws from: a fresh generator seeded
    with ``fixed_seed_offset`` when one is given, else the named generator
    ``rng_name`` (the default generator, or the innermost
    :func:`generator_scope`'s, for ``""``)."""
    if fixed_seed_offset is not None:
        gen = torch.Generator(device=_device_key(device))
        gen.manual_seed(int(fixed_seed_offset))
        return gen
    return torch_generator(device, name=rng_name or None)


def get_rng_state() -> list:
    return ([_default_generator.get_state()]
            + [g.get_state() for g in _named_generators.values()])


def set_rng_state(states: list) -> None:
    gens = [_default_generator] + list(_named_generators.values())
    for g, s in zip(gens, states):
        g.set_state(s)


def capture() -> tuple:
    """A snapshot of every port stream: the default and named generators'
    states and the :func:`generator_scope` stack with its generators'
    states. :func:`replay` re-enters it (activation recompute: a recomputed
    dropout must draw the mask its forward drew)."""
    scopes = list(_scope_stack)
    return (get_rng_state(), list(_named_generators), scopes,
            [g.get_state() for g in scopes])


@contextmanager
def replay(snapshot: tuple):
    """Run the block with the streams as :func:`capture` saw them (a named
    generator created since then starts from its seed again), then put
    every stream and the scope stack back as they were before the block."""
    states, names, scopes, scope_states = snapshot
    before = capture()
    scopes_before = [g.get_state() for g in scopes]
    created = [n for n in _named_generators if n not in names]
    try:
        set_rng_state(states)
        for n in created:
            _named_generators[n].set_state(
                {"seed": _named_generators[n].initial_seed()})
        for g, st in zip(scopes, scope_states):
            g.set_state(st)
        _scope_stack[:] = scopes
        yield
    finally:
        b_states, _, b_scopes, b_scope_states = before
        set_rng_state(b_states)
        for g, st in zip(scopes + b_scopes, scopes_before + b_scope_states):
            g.set_state(st)
        _scope_stack[:] = b_scopes
