"""Retry with exponential backoff + jitter + deadline.

The port's own copy of the jax-free ``paddlepaddle_tpu/resilience/
retry.py``.

Reference surface: the reference's store/rendezvous layers retry transient
transport failures (tcp_store connect loops, elastic re-admission polls);
here the policy is one reusable object applied at the seams that talk to
other processes — TCPStore connect/get/set, checkpoint filesystem I/O, and
launcher↔worker rendezvous.

Semantics:

* attempt 1 runs immediately; before attempt ``k+1`` the caller sleeps
  ``min(base_delay * multiplier**(k-1), max_delay)`` plus uniform jitter in
  ``[0, jitter * delay]``;
* a ``deadline`` (seconds, measured from the first attempt) stops retrying
  early: no sleep is started that would cross it;
* only exceptions in ``retry_on`` are retried — anything else propagates
  immediately. :class:`~.chaos.ChaosError` is retryable by default, so
  injected faults exercise exactly this path;
* the final failure re-raises the LAST underlying exception (with prior
  attempts noted via ``__notes__``-style message), never a wrapper, so
  callers' ``except`` clauses keep working.

Every retry and every exhaustion increments observability counters
(``paddle_retry_attempts_total`` / ``paddle_retry_exhausted_total``,
labeled by ``op``), so fault handling is visible in metrics snapshots.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from functools import wraps
from typing import Callable, Optional, Tuple, Type

from .chaos import ChaosError

__all__ = ["RetryPolicy", "call_with_retry", "retry", "compute_delay"]

# transient by default: OS/transport errors, timeouts, injected faults
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    OSError, ConnectionError, TimeoutError, ChaosError)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25          # fraction of the backoff added uniformly
    deadline: Optional[float] = None  # total budget (s) across all attempts
    retry_on: Tuple[Type[BaseException], ...] = field(
        default=DEFAULT_RETRYABLE)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.multiplier < 1:
            raise ValueError("multiplier must be >= 1")


def compute_delay(policy: RetryPolicy, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
    """Backoff before attempt ``attempt+1`` (``attempt`` is the 1-based
    attempt that just failed)."""
    base = min(policy.base_delay * policy.multiplier ** (attempt - 1),
               policy.max_delay)
    if policy.jitter <= 0:
        return base
    r = rng.random() if rng is not None else random.random()
    return base + base * policy.jitter * r


def _count(name: str, help_: str, op: str, **flight_data) -> None:
    try:
        from ..observability import flight, safe_inc
    except Exception:
        return
    safe_inc(name, help_, op=op)
    # flight-recorder breadcrumb: a crash dump shows the retry storm that
    # preceded it ("retry" = about to back off, "retry_exhausted" = gave up)
    kind = "retry_exhausted" if name.endswith("exhausted_total") else "retry"
    flight.record(kind, op, **flight_data)


def call_with_retry(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
                    name: Optional[str] = None,
                    on_retry: Optional[Callable] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    rng: Optional[random.Random] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy``. ``on_retry(attempt,
    exc, delay)`` is invoked before each backoff sleep (tests/logging);
    ``sleep``/``rng`` are injectable for deterministic unit tests."""
    policy = policy or RetryPolicy()
    op = name or getattr(fn, "__name__", "call")
    start = time.monotonic()
    last_exc = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last_exc = e
            if attempt >= policy.max_attempts:
                break
            delay = compute_delay(policy, attempt, rng)
            if policy.deadline is not None and (
                    time.monotonic() - start + delay > policy.deadline):
                break
            _count("paddle_retry_attempts_total",
                   "retries performed after a transient failure, by op", op,
                   attempt=attempt, delay_s=round(delay, 4),
                   error=f"{type(e).__name__}: {e}"[:200])
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    _count("paddle_retry_exhausted_total",
           "operations that failed after exhausting their retry policy, "
           "by op", op)
    raise last_exc


def retry(policy: Optional[RetryPolicy] = None, name: Optional[str] = None):
    """Decorator form: ``@retry(RetryPolicy(max_attempts=3))``."""

    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retry(fn, *args, policy=policy,
                                   name=name or fn.__name__, **kwargs)

        return wrapper

    return deco
