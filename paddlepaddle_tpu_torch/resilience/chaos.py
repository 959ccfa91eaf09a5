"""Deterministic fault injection — make failure a testable input.

The port's own copy of the jax-free ``paddlepaddle_tpu/resilience/
chaos.py``: the same specs, schedules and per-point seeded streams, so one
spec and seed fire on the same hits in both packages. The port's seams are
``serving.admit`` and ``serving.decode`` (:mod:`..inference.serving`), the
store's, ``collective.launch``, ``ckpt.write_shard``, ``step`` (the
watchdog) and ``dataloader.worker`` (:mod:`..io.dataloader`).

Reference surface: the reference stack treats failure as a first-class event
(CommTaskManager timeout/abort, paddle/phi/core/distributed/
comm_task_manager.h:37; elastic restart, fleet/elastic/manager.py). This
module provides the *other half* of that story: a way to PRODUCE faults on a
reproducible schedule so the handling paths can be exercised in CI instead
of waiting for a real preemption.

Injection points are named seams the runtime already calls through::

    store.connect / store.get / store.set   TCPStore client ops
    collective.launch                       eager collective entry
    ckpt.write_shard                        checkpoint shard file write
    dataloader.worker                       per-batch inside a worker process
    step                                    watchdog-bracketed train step
    serving.admit                           ServingEngine submit admission
    serving.decode                          serving decode attempt (a chaos
                                            storm here exercises the
                                            serving circuit breaker)

Each ``chaos_point(name)`` call is a no-op (one module-global ``is None``
check) until chaos is armed, either programmatically via :func:`configure`
or by env vars read lazily at the first point hit (so launcher-spawned
worker processes inherit the schedule through their environment):

* ``PADDLE_CHAOS_POINTS`` — ``;``-separated specs ``name:mode:sched[:arg]``:
    - ``mode``: ``exc`` (raise :class:`ChaosError`), ``latency`` (sleep
      ``arg`` seconds, default 0.05), ``kill`` (``os._exit(arg)``, default
      exit code 173).
    - ``sched``: ``0.25`` (probability per hit, drawn from a per-point
      seeded RNG), ``@N`` (exactly the Nth hit, 1-based), ``%N`` (every Nth
      hit), ``xN`` (the first N hits).
* ``PADDLE_CHAOS_SEED`` — base seed; each point derives its own RNG stream
  from ``crc32(point_name) ^ seed`` so the decision sequence at one point is
  independent of interleaving with other points.

Determinism contract: with a fixed seed and a fixed per-point hit sequence,
the set of fired injections is identical run-to-run — a chaos test failure
is replayable with the seed it printed.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional

__all__ = [
    "ChaosError", "ChaosSpec", "chaos_point", "configure", "disable",
    "is_active", "fire_counts", "hit_counts", "parse_specs",
]


class ChaosError(RuntimeError):
    """An injected (synthetic) failure. Retry layers treat it as transient."""


class ChaosSpec:
    """One armed injection: point name, failure mode, firing schedule."""

    __slots__ = ("point", "mode", "sched_kind", "sched_value", "arg")

    def __init__(self, point: str, mode: str, sched_kind: str,
                 sched_value: float, arg: Optional[float] = None):
        if mode not in ("exc", "latency", "kill"):
            raise ValueError(f"chaos mode {mode!r} not in exc|latency|kill")
        if sched_kind not in ("prob", "at", "every", "first"):
            raise ValueError(f"chaos schedule kind {sched_kind!r} unknown")
        self.point = point
        self.mode = mode
        self.sched_kind = sched_kind
        self.sched_value = sched_value
        self.arg = arg

    def should_fire(self, hit: int, rng: random.Random) -> bool:
        """``hit`` is 1-based. Probability draws ALWAYS consume the RNG so
        the stream position depends only on the hit count, keeping decisions
        reproducible even if specs at other points change."""
        if self.sched_kind == "prob":
            return rng.random() < self.sched_value
        if self.sched_kind == "at":
            return hit == int(self.sched_value)
        if self.sched_kind == "every":
            return hit % int(self.sched_value) == 0
        return hit <= int(self.sched_value)  # first

    def __repr__(self):
        return (f"ChaosSpec({self.point}:{self.mode}:"
                f"{self.sched_kind}={self.sched_value:g}"
                + (f":{self.arg:g}" if self.arg is not None else "") + ")")


def parse_specs(text: str) -> List[ChaosSpec]:
    """``name:mode:sched[:arg]`` entries separated by ``;`` or ``,``."""
    specs = []
    for entry in text.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 3:
            raise ValueError(
                f"chaos spec {entry!r} needs name:mode:sched[:arg]")
        name, mode, sched = parts[0], parts[1], parts[2]
        arg = float(parts[3]) if len(parts) > 3 else None
        if sched.startswith("@"):
            kind, val = "at", float(sched[1:])
        elif sched.startswith("%"):
            kind, val = "every", float(sched[1:])
        elif sched.startswith("x"):
            kind, val = "first", float(sched[1:])
        else:
            kind, val = "prob", float(sched)
        specs.append(ChaosSpec(name, mode, kind, val, arg))
    return specs


class _Engine:
    def __init__(self, specs: List[ChaosSpec], seed: int):
        self.seed = seed
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[ChaosSpec]] = {}
        for s in specs:
            self._by_point.setdefault(s.point, []).append(s)
        self._hits: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}

    def hit(self, point: str):
        specs = self._by_point.get(point)
        with self._lock:
            # count EVERY hit (also of un-armed points) so tests can assert
            # seams are actually wired without arming a failure there
            hit = self._hits[point] = self._hits.get(point, 0) + 1
            if not specs:
                return None
            rng = self._rngs.get(point)
            if rng is None:
                rng = self._rngs[point] = random.Random(
                    zlib.crc32(point.encode()) ^ self.seed)
            fired = [s for s in specs if s.should_fire(hit, rng)]
            if fired:
                self._fires[point] = self._fires.get(point, 0) + len(fired)
        return fired or None


_engine: Optional[_Engine] = None
_env_checked = False
_env_lock = threading.Lock()


def configure(specs, seed: int = 0) -> None:
    """Arm chaos programmatically. ``specs`` is a spec string (env syntax)
    or a list of :class:`ChaosSpec`."""
    global _engine, _env_checked
    if isinstance(specs, str):
        specs = parse_specs(specs)
    _engine = _Engine(list(specs), seed)
    _env_checked = True


def disable() -> None:
    global _engine, _env_checked
    _engine = None
    _env_checked = True


def is_active() -> bool:
    _maybe_init_from_env()
    return _engine is not None


def fire_counts() -> Dict[str, int]:
    """{point: injections fired} — what tests and metrics dashboards read."""
    eng = _engine
    if eng is None:
        return {}
    with eng._lock:  # hit() mutates these dicts concurrently
        return dict(eng._fires)


def hit_counts() -> Dict[str, int]:
    """{point: times the seam was crossed} (armed or not)."""
    eng = _engine
    if eng is None:
        return {}
    with eng._lock:
        return dict(eng._hits)


def _maybe_init_from_env() -> None:
    global _engine, _env_checked
    if _env_checked:
        return
    with _env_lock:
        if _env_checked:
            return
        text = os.environ.get("PADDLE_CHAOS_POINTS", "").strip()
        if text:
            seed = int(os.environ.get("PADDLE_CHAOS_SEED", "0") or 0)
            _engine = _Engine(parse_specs(text), seed)
            sys.stderr.write(
                f"[chaos] armed from env: {text!r} seed={seed}\n")
        _env_checked = True


def _emit_metric(point: str, mode: str) -> None:
    # cold path (an injection is firing); observability import stays out of
    # the un-armed fast path entirely
    try:
        from ..observability import flight, safe_inc
    except Exception:
        return
    safe_inc("paddle_chaos_injections_total",
             "synthetic faults fired by the chaos engine, by point and mode",
             point=point, mode=mode)
    flight.record("chaos", point, mode=mode)


def chaos_point(name: str) -> None:
    """Cross a named injection seam. No-op unless chaos is armed for it.

    Order when several specs fire on one hit: latency first (delay then
    fail models a slow-then-dead peer), then kill, then exc.
    """
    if _engine is None and _env_checked:
        return
    _maybe_init_from_env()
    eng = _engine
    if eng is None:
        return
    fired = eng.hit(name)
    if not fired:
        return
    fired.sort(key=lambda s: {"latency": 0, "kill": 1, "exc": 2}[s.mode])
    for spec in fired:
        _emit_metric(name, spec.mode)
        if spec.mode == "latency":
            time.sleep(spec.arg if spec.arg is not None else 0.05)
        elif spec.mode == "kill":
            code = int(spec.arg) if spec.arg is not None else 173
            sys.stderr.write(
                f"[chaos] kill injected at {name!r} (exit {code})\n")
            sys.stderr.flush()
            # os._exit skips atexit AND excepthooks: flush the black box
            # here or the drill that killed the worker leaves no evidence
            try:
                from ..observability import flight

                flight.dump(f"chaos_kill:{name}")
            except Exception:
                pass
            os._exit(code)
        else:
            raise ChaosError(f"chaos injected at {name!r} "
                             f"(seed={eng.seed}, hit={eng._hits.get(name)})")
