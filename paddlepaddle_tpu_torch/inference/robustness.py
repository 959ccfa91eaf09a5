"""Serving robustness primitives — typed shed errors, circuit breaker,
queue-wait estimation.

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
robustness.py``: the typed admission errors a client of ``ServingEngine``
sees, :class:`CircuitBreaker` and :class:`QueueWaitEstimator`, unchanged.
``safe_inc`` / ``safe_set`` write the cold-path counters and gauges into
the observability registry (:mod:`..observability`), always, and never
raise. The fleet and wire half (reference :127-248): the errors of the
router (``FleetUnavailableError``), the deploy pipeline (``DeployError``)
and the replica wire (``ReplicaStalledError``, ``WireCorruptionError``),
and ``error_to_wire`` / ``error_from_wire``, whose document is the
reference's key for key, so a port client and a reference server (or the
reverse) rehydrate the same exception class.

Everything here is plain host-side bookkeeping, safe to use from any thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = [
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "RequestCancelledError", "CircuitOpenError", "EngineDrainingError",
    "RequestValidationError", "KVCapacityError", "FleetUnavailableError",
    "DeployError", "ReplicaStalledError", "WireCorruptionError",
    "CircuitBreaker", "QueueWaitEstimator", "safe_inc",
    "safe_set", "error_to_wire", "error_from_wire",
]


def safe_inc(name: str, help_: str, n: float = 1, **labels) -> None:
    """Cold-path fault/event counter (sheds, breaker flips, drains, prefix
    hits/evictions): always records, never raises, costs nothing on the
    serve path. Shared by serving.py, decode_engine.py and speculative.py."""
    try:
        from ..observability import safe_inc as inc

        inc(name, help_, n, **labels)
    except Exception:
        pass


def safe_set(name: str, help_: str, value: float, **labels) -> None:
    """Best-effort cold-path gauge write, same contract as
    :func:`safe_inc`."""
    try:
        from ..observability import safe_set as set_

        set_(name, help_, value, **labels)
    except Exception:
        pass


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


class FleetUnavailableError(ServingError):
    """Every replica behind the :class:`~.router.ServingRouter` is out of
    rotation (evicted by its breaker, draining, or dead) — the fleet as a
    whole cannot admit the request. Carries the replica census and a
    retry-after hint (the soonest half-open probe window among the evicted
    replicas) so clients back off instead of hammering a dead fleet."""

    def __init__(self, msg: str, replicas: int = 0, healthy: int = 0,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.replicas = int(replicas)
        self.healthy = int(healthy)
        self.retry_after_s = float(retry_after_s)


class ReplicaStalledError(ServingError):
    """The stream-progress watchdog tripped: a replica connection accepted
    the request (or was mid-stream) but produced NO frame — chunk, progress
    or heartbeat — within ``heartbeat_timeout_s``. A black-holed or
    partitioned connection, not a slow decode: the server heartbeats every
    ``heartbeat_interval_s`` even when there is nothing to report, so
    silence means the wire (or the peer) is gone. Retryable — another
    replica can serve the request, and the stalled connection is closed so
    the server's disconnect probe releases the decode slot."""

    def __init__(self, msg: str, stalled_after_s: float = 0.0):
        super().__init__(msg)
        self.stalled_after_s = float(stalled_after_s)


class WireCorruptionError(ServingError):
    """A frame failed its CRC32 payload check: bytes were damaged in
    transit. The connection is abandoned (a desynced stream cannot be
    trusted for one more frame) and the request is retryable — corruption
    must surface as a typed infra failure, NEVER as wrong tokens."""


class DeployError(ServingError):
    """A :meth:`~.fleet.FleetController.deploy` could not START: the
    candidate bundle failed pre-flight validation (missing/garbled
    manifest, corrupt payload, unsupported format), or another deploy is
    already in flight. Raised BEFORE any replica is touched — a rejected
    candidate costs nothing. (A deploy that starts and then fails its
    canary gate or regresses mid-rollout does NOT raise: it rolls back
    and reports ``ok=False`` in its result, because a bad candidate is an
    expected outcome the pipeline exists to absorb.) Carries the stage
    that refused and the reasons."""

    def __init__(self, msg: str, stage: str = "validate",
                 reasons: Optional[list] = None):
        super().__init__(msg)
        self.stage = str(stage)
        self.reasons = list(reasons or [])


# ---------------------------------------------------------------------------
# wire (de)serialization — the process boundary's half of the taxonomy.
#
# A remote replica (inference/replica_main.py) reports failures as a typed
# error frame: {"type": <class name>, "msg": str(exc), "fields": {...}}.
# error_from_wire rebuilds the SAME exception class with the SAME extra
# fields (retry_after_s, queue_depth, ...) on the client side, so the
# router's _retryable() classification, breaker evidence, and client
# backoff hints are byte-identical whether the replica is a thread or a
# process. An unknown type (a replica running newer code, or a raw engine
# crash) rehydrates as an untyped RuntimeError — which the router treats
# as retryable infra failure, exactly what a crashed process should be.
# ---------------------------------------------------------------------------

_WIRE_FIELDS = {
    "ServerOverloadedError": ("queue_depth", "retry_after_s"),
    "CircuitOpenError": ("retry_after_s",),
    "KVCapacityError": ("pages_needed", "pages_capacity"),
    "FleetUnavailableError": ("replicas", "healthy", "retry_after_s"),
    "DeployError": ("stage", "reasons"),
    "ReplicaStalledError": ("stalled_after_s",),
}


def error_to_wire(exc: BaseException) -> dict:
    """One JSON-able dict per exception: class name, message, and the
    class's extra constructor fields (so hints like ``retry_after_s``
    survive the hop). Never raises — a serialization failure degrades to
    an untyped record, not a lost error."""
    doc = {"type": type(exc).__name__, "msg": str(exc)}
    try:
        fields = {}
        for f in _WIRE_FIELDS.get(doc["type"], ()):
            v = getattr(exc, f, None)
            if v is not None:
                fields[f] = v
        if fields:
            doc["fields"] = fields
    except Exception:
        pass
    return doc


def error_from_wire(doc: dict) -> BaseException:
    """Rebuild the typed exception a replica process reported. Unknown
    (or untyped) error types come back as ``RuntimeError`` — the router
    classifies those as retryable infra failures, which is the correct
    reading of \"the remote engine blew up\"."""
    name = str(doc.get("type") or "RuntimeError")
    msg = str(doc.get("msg") or "remote replica error")
    fields = doc.get("fields") or {}
    cls = globals().get(name)
    if (not isinstance(cls, type) or not issubclass(cls, ServingError)):
        # deliberate: client-side cancellation/timeouts keep their stdlib
        # types so caller except-clauses (TimeoutError) still match
        if name == "TimeoutError":
            return TimeoutError(msg)
        return RuntimeError(f"{name}: {msg}" if name != "RuntimeError"
                            else msg)
    try:
        known = {f: fields[f] for f in _WIRE_FIELDS.get(name, ())
                 if f in fields}
        return cls(msg, **known)
    except Exception:
        return cls(msg)
