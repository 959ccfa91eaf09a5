"""Serving robustness primitives — typed shed errors, circuit breaker,
queue-wait estimation.

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
robustness.py``: the typed admission errors a client of ``ServingEngine``
sees, :class:`CircuitBreaker` and :class:`QueueWaitEstimator`, unchanged.
``safe_inc`` / ``safe_set`` keep their signatures but record nothing until
observability is ported (ROADMAP A8). The fleet and wire errors
(``FleetUnavailableError``, ``DeployError``, ``ReplicaStalledError``,
``WireCorruptionError``, ``error_to_wire`` / ``error_from_wire``) come with
the fleet (ROADMAP A7).

Everything here is plain host-side bookkeeping, safe to use from any thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = [
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "RequestCancelledError", "CircuitOpenError", "EngineDrainingError",
    "RequestValidationError", "KVCapacityError", "CircuitBreaker",
    "QueueWaitEstimator", "safe_inc", "safe_set",
]


def safe_inc(name: str, help_: str, n: float = 1, **labels) -> None:
    """Cold-path event counter; a no-op until observability is ported."""


def safe_set(name: str, help_: str, value: float, **labels) -> None:
    """Cold-path gauge write; a no-op until observability is ported."""


class ServingError(RuntimeError):
    """Base of every typed serving-robustness error."""


class ServerOverloadedError(ServingError):
    """Load shed: the queue is full (or its estimated wait is over the
    bound). Carries the observed depth and a retry-after hint so a client
    can back off instead of hammering."""

    def __init__(self, msg: str, queue_depth: int = 0,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceededError(ServingError):
    """The request's deadline passed before (or while) it was served."""


class RequestCancelledError(ServingError):
    """The client cancelled the request (``GenerationResult.cancel()``)."""


class CircuitOpenError(ServingError):
    """The decode circuit breaker is open: recent decodes failed (or hung),
    so submits fail fast instead of queueing behind a sick engine."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class EngineDrainingError(ServingError):
    """The engine is draining (or drained): admission is closed for good."""


class RequestValidationError(ValueError, ServingError):
    """The request can never be served (prompt + budget over ``max_len``,
    non-positive budget) — rejected at submit, before it costs a queue
    slot. A ``ValueError`` so pre-existing callers' handlers still match."""


class KVCapacityError(RequestValidationError):
    """The request's prompt + token budget needs more KV pages than the
    paged pool holds EVEN WHEN EMPTY — waiting for retirements can never
    help, so it is rejected at submit (shed, reason ``kv_capacity``)
    instead of deadlocking at the head of the queue. Before the paged
    pool, admission only checked against ``max_len``; a pool sized below
    ``slots x max_len`` makes this its own failure mode."""

    def __init__(self, msg: str, pages_needed: int = 0,
                 pages_capacity: int = 0):
        super().__init__(msg)
        self.pages_needed = int(pages_needed)
        self.pages_capacity = int(pages_capacity)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probe recovery.

    States: ``closed`` (normal), ``open`` (fail fast until ``reset_s``
    elapses), ``half_open`` (one probe in flight; its outcome decides).
    ``trip()`` force-opens regardless of counts — the hung-decode watchdog
    uses it. Thread-safe: submits check it from client threads while the
    engine thread records outcomes.
    """

    def __init__(self, threshold: int = 5, reset_s: float = 30.0,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()
        self._on_transition = on_transition

    @property
    def state(self) -> str:
        if self._state == "closed":
            return "closed"     # lock-free steady state (see allow())
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive

    def _transition(self, new: str) -> None:
        # lock held by caller
        old = self._state
        if old == new:
            return
        self._state = new
        if new == "open":
            self._opened_at = time.monotonic()
        cb = self._on_transition
        if cb is not None:
            try:
                cb(old, new)
            except Exception:
                pass  # observability must not break the breaker

    def _maybe_half_open(self) -> None:
        # lock held by caller
        if (self._state == "open"
                and time.monotonic() - self._opened_at >= self.reset_s):
            self._transition("half_open")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == "half_open":
                self._transition("open")      # probe failed: back to open
            elif (self._state == "closed"
                    and self._consecutive >= self.threshold):
                self._transition("open")

    def record_success(self) -> None:
        if self._state == "closed" and self._consecutive == 0:
            return      # steady state: one decode attempt per batch must
        with self._lock:  # not pay a lock round-trip
            self._consecutive = 0
            if self._state != "closed":       # probe (or late hung decode
                self._transition("closed")    # returning) succeeded

    def trip(self) -> None:
        """Force-open (watchdog: a decode is hung, stop queueing behind it)."""
        with self._lock:
            self._consecutive = max(self._consecutive, self.threshold)
            self._transition("open")

    def reset(self) -> None:
        """Return to ``closed`` with zero failures. For backend
        replacement (engine restart after drain, a router replica swapped
        for a fresh one): the new backend must not inherit its
        predecessor's failure history or sit out a stale reset window."""
        with self._lock:
            self._consecutive = 0
            self._transition("closed")

    def allow(self) -> bool:
        """True when work may proceed (closed, or open long enough that a
        half-open probe is due). False = fail fast.

        Lock-free when closed: the submit fast path must cost attribute
        reads, and a submit that races the closed->open transition merely
        queues one request the decode loop will hold anyway."""
        if self._state == "closed":
            return True
        with self._lock:
            self._maybe_half_open()
            return self._state != "open"

    def retry_after_s(self) -> float:
        """Hint for fail-fast errors: time until the next half-open probe."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0, self.reset_s
                       - (time.monotonic() - self._opened_at))


class QueueWaitEstimator:
    """EWMA of decode-attempt wall time → estimated queue wait.

    One sample per decode attempt (a static batch or a continuous chunk);
    the estimated wait for a request entering at depth ``d`` with ``b``
    requests served per attempt is ``(d / b) * ewma`` — the time spent
    behind others, not its own service. Crude on purpose — the point is a
    load-shedding signal and a retry-after hint, not an SLA; it converges
    within a handful of attempts either way.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._ewma = 0.0

    def observe(self, seconds: float) -> None:
        if self._ewma == 0.0:
            self._ewma = float(seconds)
        else:
            self._ewma += self.alpha * (float(seconds) - self._ewma)

    @property
    def ewma_s(self) -> float:
        return self._ewma

    def estimate_wait_s(self, depth: int, per_attempt: int) -> float:
        """Estimated seconds a request entering now waits before decoding
        starts; 0.0 until the first sample lands (never shed blind)."""
        if self._ewma == 0.0:
            return 0.0
        return (depth / max(1, per_attempt)) * self._ewma
