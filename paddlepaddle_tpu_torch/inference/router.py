"""Serving fleet router — health-aware load balancing, replica failover,
rolling restart over N decode engines.

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
router.py``, over the port's :class:`~.serving.ServingEngine`. Two things
differ, both about threads. A failed-over request is resubmitted from the
router's retry thread, never from the callback that reports the failure:
that callback runs on the failing replica's scheduler thread (or a remote
client's reader), and a submit to a remote replica blocks on the wire, which
would stall that replica's decode loop. And on the card an in-process
replica's warmup is a CUDA-graph capture taken while the other replicas
decode in the same process, which the port's captured programs allow
(``decode_engine._CapturedProgram``: thread-local capture and launch counts
kept per capture).

Reference surface: the reference deployment layer's predictor POOL
(paddle/fluid/inference/api/paddle_inference_api.h:229 PredictorPool) scaled
from "a pool of handles in one process" to "a fleet of replica engines
behind one front door". The engine carries every signal a fleet needs —
``health()`` snapshots with ``est_wait_s``/``inflight``/``pages_free``,
``drain(timeout)``, per-engine circuit breakers, per-request SLO stamps,
and a replica-local prefix cache; :class:`ServingRouter` is the component
that finally *uses* them together, turning one engine into a service.

Mechanics (all stdlib — the replicas own the device):

* **health-aware balancing** — a prober thread polls every replica's
  ``health()`` each ``probe_interval_s``; picks go to the healthy replica
  with the least estimated wait (snapshot ``est_wait_s``, live router-side
  in-flight count as the tiebreak). A per-replica
  :class:`~.robustness.CircuitBreaker` evicts a replica whose probes or
  requests keep failing and re-admits it via the half-open window once a
  probe sees ``ok`` again.
* **failover with retry** — a request whose replica dies mid-flight
  (breaker-open, typed infra shed, chaos kill) is re-submitted to another
  replica under a :class:`~..resilience.retry.RetryPolicy`: bounded
  attempts, jittered exponential backoff between fleet-wide rounds, and
  deadline-aware — no retry is ever scheduled past the request's
  ``deadline_s``. Requests that can never succeed anywhere (validation,
  expired deadline, client cancel) are NOT retried. When every replica is
  out of rotation, submits raise a typed
  :class:`~.robustness.FleetUnavailableError` (with the soonest half-open
  window as the retry hint).
* **rolling restart** — :meth:`ServingRouter.rolling_restart` takes one
  replica out of rotation, drains it (in-flight requests finish; queued
  ones shed typed and FAIL OVER to the other replicas), restarts it with a
  fresh engine, waits until its health probe reads ok, re-admits it, then
  proceeds to the next — a deploy drops zero requests. The per-replica
  cycle is :meth:`ServingRouter.restart_replica` (``factory=`` swaps the
  build recipe, ``readmit=False`` holds a healthy replica out of rotation)
  — the unit the fleet controller's deploy/rollback pipeline reuses.
* **elastic membership** — :meth:`ServingRouter.add_replica` joins a
  started (ideally pre-warmed) replica to the rotation under live traffic;
  :meth:`ServingRouter.remove_replica` leaves DELIBERATELY by drain
  (sheds fail over, no breaker evidence, the engine's ``/healthz``
  provider unregisters, router-side breaker/prober state is dropped).
  Rendezvous hashing bounds prefix-key movement to the joining/leaving
  replica — the fleet-wide cache hit rate survives scaling. The
  SLO-driven autoscaler that drives these lives in :mod:`~.fleet`.
* **prefix-affine routing** — requests declaring ``prefix_len`` rendezvous-
  hash their prefix tokens over the healthy replicas, so every request
  sharing a system prompt lands on the replica whose paged prefix cache
  already holds its pages; the router falls back to least-loaded
  when the preferred replica is unhealthy or saturated
  (``affinity_max_wait_s``).

The replica seam is :class:`ReplicaClient` — the four-method surface the
router needs (``submit/health/drain/restart``). The in-process form wraps a
:class:`~.serving.ServingEngine` factory; a remote replica (HTTP
``/healthz`` + the C-API submit protocol) slots in by implementing the same
surface.

Observability: ``paddle_router_{picks,retries,failovers,evictions,
readmissions}_total`` counters + ``paddle_router_replicas_healthy`` gauge
(cold paths, via safe_inc/safe_set), a ``router`` block in
:meth:`ServingRouter.health`, and eviction/failover/rolling-restart events
through the crash flight recorder.

Invariant the chaos drill enforces (tests/test_router.py): every submitted
request's future resolves — completed, or failed with a typed error. Zero
silently-lost futures, whatever dies.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..resilience.retry import RetryPolicy, compute_delay
from .robustness import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    EngineDrainingError,
    FleetUnavailableError,
    ReplicaStalledError,
    RequestCancelledError,
    ServerOverloadedError,
    ServingError,
    WireCorruptionError,
)
from .robustness import safe_inc as _safe_inc
from .robustness import safe_set as _safe_set
from .serving import _REQ_IDS, GenerationResult, ServingEngine
from .serving import _flight_record  # one disarmed-check wrapper, not two


def _retryable(exc: BaseException) -> bool:
    """May another replica serve this request? Infra failures — overload,
    open breaker, draining replica, or anything that is NOT a typed
    serving error (decode blew up, chaos, dead replica) — yes. Failures
    that travel with the request (validation, expired deadline, client
    cancel) or with the whole fleet (FleetUnavailableError) — no. The
    wire-hardening errors are typed ServingErrors but travel with the
    CONNECTION, not the request — a stalled or corrupted stream says
    nothing about whether another replica can serve it."""
    if isinstance(exc, (CircuitOpenError, EngineDrainingError,
                        ServerOverloadedError, ReplicaStalledError,
                        WireCorruptionError)):
        return True
    return not isinstance(exc, ServingError)


class ReplicaClient:
    """The seam between the router and ONE replica. In-process form: owns a
    :class:`~.serving.ServingEngine` built by ``factory`` (a zero-arg
    callable), rebuilt fresh on :meth:`restart`. The remote form —
    :class:`~.remote_replica.RemoteReplicaClient`, speaking the C-API
    frame protocol to a supervised OS process — implements this same
    surface and slots in unchanged.

    ``kill()`` is the chaos seam: abrupt replica death. In-flight futures
    fail untyped (the router's failover path), and the replica refuses
    everything — including health probes — until :meth:`restart`.
    """

    # a client advertising req_uid support accepts submit(req_uid=...)
    # and guarantees a resubmitted uid is never decoded twice — the
    # precondition for the router's hedged requests (cancelling the
    # loser is safe) and ambiguous-failure resubmission
    supports_req_uid = False

    def __init__(self, factory: Callable[[], ServingEngine],
                 name: str = "replica"):
        self._factory = factory
        self.name = name
        self.engine = factory()
        self.generation = 0          # bumped per fresh engine
        self._killed = False

    def start(self) -> "ReplicaClient":
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        self.engine.start()
        return self

    def submit(self, prompt_ids, **kw) -> GenerationResult:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        return self.engine.submit(prompt_ids, **kw)

    def health(self) -> Dict[str, object]:
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        return self.engine.health()

    def warmup(self) -> Dict[str, object]:
        """Pre-compile the replica's whole plan (rolling restart calls
        this between the fresh build and re-admission). Duck-typed: an
        engine without a warmup surface — a bare test double, a remote
        replica that warms itself at boot — reports a no-op."""
        if self._killed:
            raise ConnectionError(f"replica {self.name} is dead")
        fn = getattr(self.engine, "warmup", None)
        return fn() if callable(fn) else {"programs": 0, "compiled": 0}

    def drain(self, timeout: Optional[float] = None,
              reason: Optional[str] = None) -> Dict[str, object]:
        if reason is None:
            return self.engine.drain(timeout)
        try:
            # deliberate drains (scale-down) carry their reason into the
            # engine's shed/drain accounting; a foreign engine predating
            # the kwarg still drains fine
            return self.engine.drain(timeout, reason=reason)
        except TypeError:
            return self.engine.drain(timeout)

    def stop(self) -> None:
        try:
            self.engine.stop()
        except RuntimeError:
            pass          # overran the join: futures were already failed

    def restart(self, drain_timeout: Optional[float] = None,
                factory: Optional[Callable[[], ServingEngine]] = None
                ) -> None:
        """Drain the current engine (in-flight finishes, queued sheds
        typed), replace it with a FRESH one from the factory, start it.
        ``factory`` REPLACES the build recipe for this and every later
        restart — the deploy pipeline's version-switch seam (candidate
        bundle on rollout, previous bundle on rollback). Also the
        recovery path after :meth:`kill`."""
        old = self.engine
        try:
            old.drain(drain_timeout)
        except Exception:
            pass
        try:
            old.stop()
        except RuntimeError:
            pass
        if factory is not None:
            self._factory = factory
        self.engine = self._factory()
        self.engine.start()
        self.generation += 1
        self._killed = False

    def kill(self) -> None:
        """Chaos seam: the replica dies NOW. ``stop()`` fails its in-flight
        and queued futures (untyped RuntimeError — exactly what a crashed
        process looks like to its callers), and every later submit/health
        raises until :meth:`restart`."""
        self._killed = True
        try:
            self.engine.stop()
        except RuntimeError:
            pass


class _Replica:
    """Router-side state for one replica: breaker, rotation flag, live
    in-flight count, last health snapshot."""

    __slots__ = ("name", "client", "breaker", "in_rotation", "inflight",
                 "snapshot", "no_trace")

    def __init__(self, name: str, client: ReplicaClient,
                 breaker: CircuitBreaker):
        self.name = name
        self.client = client
        self.breaker = breaker
        self.in_rotation = True      # False only during rolling restart
        self.inflight = 0            # router-submitted, not yet resolved
        self.snapshot: Optional[Dict[str, object]] = None
        self.no_trace = False        # client rejected the trace kwarg (a
        #   remote implementation of the seam predating request-journey
        #   tracing): submits to it go out without the journey


class _Pending:
    """One router request across its (re)submission attempts."""

    __slots__ = ("prompt_ids", "kw", "future", "deadline", "prefix_key",
                 "attempts", "tried", "last_error", "inner", "trace",
                 "t_attempt", "req_uid", "cur_rep", "hedge_inner",
                 "hedge_armed", "delivered", "in_submit")

    def __init__(self, prompt_ids, kw, future, deadline, prefix_key):
        self.prompt_ids = prompt_ids
        self.kw = kw                          # engine submit kwargs
        self.future = future                  # the router-owned future
        self.deadline = deadline              # absolute monotonic, or None
        self.prefix_key = prefix_key          # rendezvous key bytes, or None
        self.attempts = 0                     # submissions tried so far
        self.tried: set = set()               # replica names this round
        self.last_error: Optional[BaseException] = None
        self.inner: Optional[GenerationResult] = None   # current replica fut
        self.trace = None                     # reqtrace Journey, or None
        self.t_attempt: Optional[float] = None  # current attempt's dispatch
        #                                         stamp (perf_counter)
        self.req_uid = uuid.uuid4().hex       # idempotency key: the SAME
        #   uid rides every attempt and the hedge, so cancelling a loser
        #   (or resubmitting after an ambiguous loss) never decodes twice
        self.cur_rep: Optional[str] = None    # current attempt's replica
        self.hedge_inner: Optional[GenerationResult] = None
        self.hedge_armed = False              # hedge timer scheduled
        self.delivered = False                # terminal delivered (under
        #   the router's stats lock: primary and hedge race to deliver)
        self.in_submit: Optional[str] = None  # replica a dispatcher is
        #   currently BLOCKED submitting to — a gray accept (delayed or
        #   black-holed accepted frame) wedges the dispatch thread there
        #   for up to heartbeat_timeout_s, and the hedge must cover that
        #   window too, not just the post-accept stream


class ServingRouter:
    """Front door over N replica engines with the engine's own surface:
    ``submit()/generate()/drain()/health()`` (plus ``rolling_restart()``).

    ``replicas`` is a list of zero-arg engine factories (each wrapped in a
    :class:`ReplicaClient` named ``r0..rN-1``) and/or ready
    :class:`ReplicaClient` instances. Factories matter: rolling restart
    replaces a replica's engine with a FRESH build, it does not resurrect
    the old object.
    """

    def __init__(self, replicas: Sequence,
                 probe_interval_s: float = 0.25,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 affinity_max_wait_s: float = 1.0,
                 drain_timeout_s: Optional[float] = None,
                 hedge_after_s: Union[float, str, None] = "auto",
                 hedge_budget_pct: float = 10.0):
        if not replicas:
            raise ValueError("ServingRouter needs at least one replica")
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        # _replicas is treated as an IMMUTABLE snapshot: every reader takes
        # one attribute load and iterates its own list; add/remove swap in
        # a fresh list (GIL-atomic), so the fleet controller can grow and
        # shrink the rotation under live traffic without a reader lock
        self._replicas: List[_Replica] = []
        for i, r in enumerate(replicas):
            client = r if isinstance(r, ReplicaClient) \
                else ReplicaClient(r, name=f"r{i}")
            self._replicas.append(self._make_replica(client))
        if len({r.name for r in self._replicas}) != len(self._replicas):
            raise ValueError("replica names must be unique")
        self.probe_interval_s = float(probe_interval_s)
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=1.0)
        self.affinity_max_wait_s = float(affinity_max_wait_s)
        self.drain_timeout_s = drain_timeout_s
        # hedged requests (Dean & Barroso, "The Tail at Scale"): a request
        # with no first token after hedge_after_s gets ONE duplicate on a
        # different healthy replica; first terminal wins, the loser is
        # cancelled (safe: req_uid dedup means a cancelled twin never
        # cost a second decode). "auto" derives the delay from observed
        # TTFT (p99, floor 2x p50) via the tsdb history plane — with no
        # history armed, auto hedging stays off. hedge_budget_pct caps
        # hedges at a fraction of submits so hedging cannot melt an
        # already-overloaded fleet
        self.hedge_after_s = hedge_after_s
        self.hedge_budget_pct = float(hedge_budget_pct)
        self._hedge_cache: Optional[float] = None
        self._hedge_cache_t = 0.0
        self._stats_lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "picks": 0, "retries": 0, "failovers": 0,
                      "evictions": 0, "readmissions": 0,
                      "rolling_restarts": 0, "replicas_added": 0,
                      "replicas_removed": 0,
                      "hedges": 0, "hedge_wins": 0}
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._retrier: Optional[threading.Thread] = None
        self._retry_cv = threading.Condition()
        self._retry_heap: List = []          # (due, seq, _Pending)
        self._retry_seq = itertools.count()
        self._started = False
        self._health_reg_name = None

    # -- bookkeeping ---------------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _make_replica(self, client: ReplicaClient) -> _Replica:
        rep = _Replica(client.name, client, CircuitBreaker(
            threshold=self.breaker_threshold, reset_s=self.breaker_reset_s))
        # transition callback needs the replica it guards
        rep.breaker._on_transition = \
            (lambda old, new, _rep=rep:
             self._on_breaker_transition(_rep, old, new))
        return rep

    def _replica(self, name: str) -> _Replica:
        for rep in self._replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r} "
                       f"(have: {[r.name for r in self._replicas]})")

    def _on_breaker_transition(self, rep: _Replica, old: str,
                               new: str) -> None:
        sys.stderr.write(
            f"[router] replica {rep.name} breaker {old} -> {new}\n")
        if new == "open":
            self._bump("evictions")
            _safe_inc("paddle_router_evictions_total",
                      "replicas evicted from rotation by their breaker",
                      replica=rep.name)
            _flight_record("router", rep.name, event="eviction",
                           consecutive=rep.breaker.consecutive_failures)
        elif new == "closed" and old in ("open", "half_open"):
            self._bump("readmissions")
            _safe_inc("paddle_router_readmissions_total",
                      "evicted replicas re-admitted to rotation",
                      replica=rep.name)
            _flight_record("router", rep.name, event="readmission")

    # -- health probing ------------------------------------------------------
    def _probe_once(self) -> int:
        """Poll every replica's health; feed the per-replica breaker
        (failures accumulate to eviction; a half-open window + an ok probe
        re-admits). Returns — and gauges — the healthy count."""
        healthy = 0
        for rep in self._replicas:
            try:
                snap = rep.client.health()
                ok = bool(snap.get("ok", False))
            except Exception:
                snap, ok = None, False
            rep.snapshot = snap
            # per-replica load gauges on the probe tick: the same numbers
            # picks are made on, published so the tsdb history plane (and
            # `obsctl top`'s sparklines) can see per-replica load over time
            if snap is not None:
                if snap.get("est_wait_s") is not None:
                    _safe_set("paddle_router_replica_est_wait_seconds",
                              "probed per-replica estimated wait",
                              float(snap["est_wait_s"]), replica=rep.name)
                _safe_set("paddle_router_replica_inflight",
                          "router-submitted requests in flight per replica",
                          rep.inflight, replica=rep.name)
            b = rep.breaker
            if not rep.in_rotation:
                continue     # deliberately out (rolling restart): its
                #              transitional not-ok is neither failure
                #              evidence nor re-admission input
            if ok:
                # an ok probe re-admits ONLY through the half-open window
                # (evicted + reset elapsed): it must neither let a replica
                # jump its reset window nor clear a closed breaker's
                # REQUEST-failure streak — "/healthz looks fine but
                # requests fail" is still grounds for eviction
                if b.state != "closed" and b.allow():
                    b.record_success()
            else:
                b.record_failure()
            if rep.in_rotation and ok and b.state != "open":
                healthy += 1
        _safe_set("paddle_router_replicas_healthy",
                  "replicas currently in rotation and passing health probes",
                  healthy)
        return healthy

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self._probe_once()

    # -- retry scheduling ----------------------------------------------------
    def _retry_loop(self) -> None:
        while True:
            with self._retry_cv:
                while not self._stop.is_set() and (
                        not self._retry_heap
                        or self._retry_heap[0][0] > time.monotonic()):
                    wait = (None if not self._retry_heap else
                            max(0.0, self._retry_heap[0][0]
                                - time.monotonic()))
                    self._retry_cv.wait(wait)
                if self._stop.is_set():
                    return
                due = []
                now = time.monotonic()
                while self._retry_heap and self._retry_heap[0][0] <= now:
                    due.append(heapq.heappop(self._retry_heap)[2:])
            for kind, pend in due:
                if kind == "hedge":
                    self._maybe_hedge(pend)
                else:
                    self._dispatch(pend)

    def _schedule(self, pend: _Pending, delay: float,
                  kind: str = "retry") -> None:
        with self._retry_cv:
            # drain()/stop() set their flag BEFORE sweeping the heap under
            # this same lock — so a push either lands before the sweep
            # (and is swept) or observes the flag here. No entry can
            # strand behind an exiting retrier thread: zero lost futures
            if self._draining.is_set() or self._stop.is_set():
                if kind == "retry":
                    self._finish_fail(pend, EngineDrainingError(
                        "request shed: serving router drained before it "
                        "was served"))
                return     # a dropped hedge timer loses nothing: the
                #            primary attempt still owns the future
            heapq.heappush(self._retry_heap,
                           (time.monotonic() + delay,
                            next(self._retry_seq), kind, pend))
            self._retry_cv.notify()

    # -- pick policy ---------------------------------------------------------
    def _candidates(self, exclude=()) -> List[_Replica]:
        out = []
        for rep in self._replicas:
            if not rep.in_rotation or rep.name in exclude:
                continue
            if not rep.breaker.allow():
                continue              # evicted; half-open lets a probe pick
            snap = rep.snapshot
            if ((snap is None or not snap.get("ok", False))
                    and rep.breaker.state == "closed"):
                # the probe already knows this replica is not serving
                # (draining, stopped, dead — health() raising leaves
                # snapshot None) even though our breaker hasn't tripped
                # yet — don't route into a known wall. Half-open still
                # lets one traffic probe through
                continue
            out.append(rep)
        return out

    @staticmethod
    def _load_score(rep: _Replica):
        snap = rep.snapshot or {}
        est = snap.get("est_wait_s")
        if est is None:
            est = snap.get("estimated_queue_wait_s") or 0.0
        depth = snap.get("queue_depth") or 0
        return (round(float(est), 6), rep.inflight + int(depth), rep.name)

    def _pick(self, pend: _Pending) -> Optional[_Replica]:
        """Least-estimated-wait among healthy replicas; prefix-carrying
        requests prefer their rendezvous-hash replica (stable as replicas
        come and go — only keys owned by a lost replica move) unless it is
        saturated."""
        cands = self._candidates(exclude=pend.tried)
        if not cands:
            return None
        if pend.prefix_key is not None:
            pref = max(cands, key=lambda r: hashlib.sha1(
                pend.prefix_key + r.name.encode()).digest())
            est = self._load_score(pref)[0]
            if est <= self.affinity_max_wait_s:
                return pref
        return min(cands, key=self._load_score)

    # -- dispatch / failover -------------------------------------------------
    def _claim_delivery(self, pend: _Pending) -> bool:
        """Exactly-once delivery gate: with a hedge in flight, the primary
        and the duplicate race to resolve the future — the loser of this
        claim must neither double-count stats nor overwrite SLO stamps."""
        with self._stats_lock:
            if pend.delivered:
                return False
            pend.delivered = True
            return True

    @staticmethod
    def _cancel_losers(pend: _Pending, winner) -> None:
        # safe by construction: both attempts carried the same req_uid,
        # so a cancelled twin whose decode already finished left a cached
        # terminal, not a second decode
        for other in (pend.inner, pend.hedge_inner):
            if other is not None and other is not winner \
                    and not other.done():
                try:
                    # thread the goodput reason: the loser's decoded
                    # tokens are hedge waste, not a client cancel. A
                    # remote replica future's cancel() is a socket
                    # disconnect with no reason channel — its replica
                    # books the tokens as "cancel" on its own ledger.
                    other.cancel(reason="hedge_loser")
                except TypeError:
                    try:
                        other.cancel()
                    except Exception:
                        pass
                except Exception:
                    pass

    def _finish_ok(self, pend: _Pending, inner: GenerationResult) -> None:
        if not self._claim_delivery(pend):
            return
        self._cancel_losers(pend, inner)
        fut = pend.future
        # carry the replica future's SLO stamps so fleet-level slo_summary
        # reports real TTFT/latency (measured from ROUTER submit time).
        # Queue wait is PER ATTEMPT: the winning inner's own submit time
        # becomes the wrapper's dispatch stamp, so a failed-over request
        # reports the wait of the attempt that served it — not the first
        # attempt's decode plus the backoff booked as "queue wait"
        fut._t_admit = inner._t_admit
        fut._t_first = inner._t_first
        fut._t_dispatch = inner._t_submit
        fut._n_new = inner._n_new
        fut._n_at_first = inner._n_at_first
        fut._streaming = inner._streaming
        self._bump("completed")
        fut._set(output=inner._output)

    def _finish_fail(self, pend: _Pending, err: BaseException,
                     sync: bool = False) -> None:
        if not self._claim_delivery(pend):
            return
        self._cancel_losers(pend, None)
        self._bump("failed")
        if sync:
            # the raise IS the delivery: the future is never set, so the
            # journey must close here or it would sit in the in-flight
            # map forever (one leak per refused request)
            tr = pend.trace
            if tr is not None:
                try:
                    from ..observability import reqtrace as _rt

                    tr.event("router.reject", replica="router",
                             error=f"{type(err).__name__}: {err}"[:200],
                             retryable=False)
                    _rt.finish_future(tr, pend.future, "rejected")
                except Exception:
                    pass
            raise err
        pend.future._set(error=err)

    def _fleet_unavailable(self) -> FleetUnavailableError:
        # soonest POSITIVE half-open window among evicted replicas; a
        # fleet that is out without open breakers (all dead/draining,
        # breakers still closed) hints one probe interval — never 0.0,
        # which would invite a tight resubmit loop against a dead fleet
        windows = [w for w in (r.breaker.retry_after_s()
                               for r in self._replicas) if w > 0]
        return FleetUnavailableError(
            f"no healthy replica in rotation ({len(self._replicas)} total; "
            "all evicted, draining or dead)",
            replicas=len(self._replicas), healthy=0,
            retry_after_s=min(windows) if windows else self.probe_interval_s)

    def _may_retry(self, pend: _Pending, delay: float = 0.0) -> bool:
        """Budget check before any resubmission: bounded attempts, and
        never schedule work past the request's deadline."""
        if pend.attempts >= self.retry_policy.max_attempts:
            return False
        if pend.deadline is not None and (
                time.monotonic() + delay >= pend.deadline):
            return False
        return True

    def _backoff_or_fail(self, pend: _Pending,
                         err: BaseException) -> None:
        """End of a fleet-wide round (every candidate tried, or none
        existed): back off jittered-exponentially and try a fresh round,
        or fail the future typed when the budget (attempts or deadline)
        is spent."""
        delay = compute_delay(self.retry_policy, max(pend.attempts, 1))
        if self._draining.is_set() or not self._may_retry(pend, delay):
            self._finish_fail(pend, err)
            return
        pend.tried.clear()
        if pend.trace is not None:
            pend.trace.event("router.backoff", replica="router",
                             delay_s=round(delay, 4),
                             after_attempt=pend.attempts)
        self._schedule(pend, delay)   # the retry counter ticks when the
        #                               resubmission actually dispatches

    def _dispatch(self, pend: _Pending, sync: bool = False) -> None:
        """Submit ``pend`` to the best replica; on submit-time infra
        errors walk the remaining replicas in the same round. ``sync``
        (the caller's first attempt) reports terminal failures by raising
        — the engine's own submit contract — instead of failing the
        future."""
        while True:
            if pend.future.done():
                return                     # cancelled while waiting
            if self._draining.is_set():
                self._finish_fail(pend, EngineDrainingError(
                    "serving router is draining; no new requests admitted"),
                    sync)
                return
            now = time.monotonic()
            if pend.deadline is not None and now >= pend.deadline:
                self._finish_fail(
                    pend, pend.last_error or DeadlineExceededError(
                        "request deadline expired before a replica could "
                        "serve it"), sync)
                return
            rep = self._pick(pend)
            tr = pend.trace
            if rep is not None and tr is not None:
                try:
                    cand = {r.name: (self._load_score(r)[0])
                            for r in self._candidates(exclude=pend.tried)}
                except Exception:
                    cand = {}
                tr.set_replica(rep.name)
                tr.event("router.pick", replica=rep.name,
                         attempt=pend.attempts + 1, candidates=cand)
            if rep is None:
                # no candidate left this round: with no failure seen yet
                # the whole fleet is out (typed FleetUnavailableError);
                # otherwise surface the last replica's typed refusal
                err = pend.last_error or self._fleet_unavailable()
                if sync:
                    self._finish_fail(pend, err, True)  # fail fast at submit
                self._backoff_or_fail(pend, err)
                return
            pend.attempts += 1
            pend.tried.add(rep.name)
            if pend.attempts > 1:
                # a resubmission actually performed (same-round walk,
                # post-backoff round, or mid-flight failover redispatch)
                self._bump("retries")
                _safe_inc("paddle_router_retries_total",
                          "request resubmissions performed by the router")
            kw = dict(pend.kw)
            if rep.no_trace:
                kw.pop("trace", None)
            if pend.deadline is not None:
                kw["deadline_s"] = max(pend.deadline - now, 1e-3)
            if getattr(rep.client, "supports_req_uid", False):
                kw["req_uid"] = pend.req_uid
            pend.t_attempt = time.perf_counter()
            # arm the hedge timer BEFORE the blocking submit: the accept
            # round trip itself can gray-fail (delayed or black-holed
            # accepted frame), wedging this thread until the stall
            # watchdog fires — exactly the tail a hedge exists to cut
            if not pend.hedge_armed and len(self._replicas) > 1:
                delay = self._hedge_delay()
                if delay is not None:
                    pend.hedge_armed = True
                    self._schedule(pend, delay, kind="hedge")
            pend.in_submit = rep.name
            try:
                inner = rep.client.submit(pend.prompt_ids, **kw)
            except BaseException as e:  # noqa: BLE001 — classify below
                pend.in_submit = None
                if (isinstance(e, TypeError) and "trace" in kw
                        and "trace" in f"{e}"):
                    # a trace-unaware replica client choked on the
                    # journey kwarg: remember, undo this pick's
                    # bookkeeping, and retry — arming an observability
                    # flag must never burn breaker evidence or take a
                    # healthy fleet out of rotation
                    rep.no_trace = True
                    pend.attempts -= 1
                    pend.tried.discard(rep.name)
                    if tr is not None and tr.replicas \
                            and tr.replicas[-1] == rep.name:
                        tr.attempts -= 1
                        tr.replicas.pop()
                        for i in range(len(tr.spans) - 1, -1, -1):
                            s = tr.spans[i]
                            if (s.get("name") == "router.pick"
                                    and s.get("replica") == rep.name):
                                del tr.spans[i]
                                break
                    continue
                if tr is not None:
                    # submit-time refusal: breaker rejection, overload
                    # backpressure, draining replica, dead connection —
                    # each lands as its own span with the typed cause
                    tr.event("router.reject", t0=pend.t_attempt,
                             replica=rep.name,
                             error=f"{type(e).__name__}: {e}"[:200],
                             retryable=_retryable(e))
                if _retryable(e):
                    if rep.in_rotation and not isinstance(
                            e, ServerOverloadedError):
                        # overload is BACKPRESSURE from a healthy engine
                        # (typed, retry_after hint), not sickness — route
                        # around it without burning eviction evidence, or
                        # a fleet-wide burst would evict every healthy
                        # replica at once
                        rep.breaker.record_failure()
                    pend.last_error = e
                    if not self._may_retry(pend):
                        self._finish_fail(pend, e, sync)
                        return
                    continue          # same round, next replica
                self._finish_fail(pend, e, sync)
                return
            pend.in_submit = None
            pend.inner = inner
            pend.cur_rep = rep.name
            if pend.future.done():
                # cancel landed between the top-of-loop check and the
                # submit: the stale-inner cancel callback missed this
                # brand-new inner — don't decode a full budget for a
                # departed client
                inner.cancel()
                return
            with self._stats_lock:
                rep.inflight += 1
                self.stats["picks"] += 1
            _safe_inc("paddle_router_picks_total",
                      "requests routed to a replica, by replica",
                      replica=rep.name)
            inner._add_done_callback(
                lambda _inner, _pend=pend, _rep=rep:
                self._on_inner_done(_pend, _rep, _inner))
            return

    def _on_inner_done(self, pend: _Pending, rep: _Replica,
                       inner: GenerationResult) -> None:
        """A replica future resolved (runs on that replica's engine
        thread). Success delivers; retryable failure fails over to another
        replica within the retry budget — the mid-flight path the chaos
        drill exists for."""
        with self._stats_lock:
            rep.inflight = max(0, rep.inflight - 1)
        err = inner._error
        fut = pend.future
        tr = pend.trace
        if tr is not None and pend.t_attempt is not None:
            # the attempt child span: dispatch -> inner resolution, tagged
            # with the replica and (on failure) the typed cause — the
            # stitched journey's failover evidence
            tr.event("router.attempt", t0=pend.t_attempt,
                     t1=time.perf_counter(), replica=rep.name,
                     attempt=pend.attempts, ok=err is None,
                     **({} if err is None else
                        {"error": f"{type(err).__name__}: {err}"[:200]}))
        if fut.done():
            return                    # client cancelled the router future
        if err is None:
            rep.breaker.record_success()
            self._finish_ok(pend, inner)
            return
        if isinstance(err, RequestCancelledError) or not _retryable(err):
            self._finish_fail(pend, err)
            return
        if rep.in_rotation:
            # a deliberately-restarting replica's drain sheds are not
            # evidence of sickness — only in-rotation failures evict
            rep.breaker.record_failure()
        pend.last_error = err
        pend.tried = {rep.name}       # new round, but not straight back
        self._bump("failovers")
        _safe_inc("paddle_router_failovers_total",
                  "requests re-routed after a mid-flight replica failure",
                  replica=rep.name)
        _flight_record("router", rep.name, event="failover",
                       req=str(fut._req_id or "?"),
                       error=f"{type(err).__name__}: {err}"[:200])
        if not self._may_retry(pend):
            self._finish_fail(pend, err)
            return
        # resubmit from the retry thread: this callback may be running on
        # the failed replica's scheduler thread, which must not block on
        # another replica's submit
        self._schedule(pend, 0.0)

    # -- hedged requests -----------------------------------------------------
    def _hedge_delay(self) -> Optional[float]:
        """The armed hedge delay in seconds, or None for no hedging.
        ``hedge_after_s`` numeric → that; ``"auto"`` → observed TTFT p99
        (floor 2× p50) from the tsdb history plane, cached ~1 s — with no
        history armed (or no TTFT data yet), auto stays OFF: hedging
        without a measured tail is just doubled load."""
        h = self.hedge_after_s
        if h is None or h == "off":
            return None
        if h != "auto":
            v = float(h)
            return v if v > 0 else None
        now = time.monotonic()
        if now - self._hedge_cache_t < 1.0:
            return self._hedge_cache
        val = None
        try:
            from ..observability import tsdb as _tsdb

            hist = _tsdb.get()
            if hist is not None:
                p99 = hist.window_agg("paddle_serving_ttft_seconds:p99",
                                      60.0, "avg")
                p50 = hist.window_agg("paddle_serving_ttft_seconds:p50",
                                      60.0, "avg")
                if p99:
                    v99 = max(p99.values())
                    v50 = max(p50.values()) if p50 else 0.0
                    val = max(float(v99), 2.0 * float(v50))
                    if val <= 0:
                        val = None
        except Exception:
            val = None
        self._hedge_cache, self._hedge_cache_t = val, now
        return val

    def _hedge_outcome(self, outcome: str) -> None:
        _safe_inc("paddle_router_hedges_total",
                  "hedged duplicate attempts by outcome "
                  "(launched/won/lost/failed/suppressed)",
                  outcome=outcome)

    def _maybe_hedge(self, pend: _Pending) -> None:
        """The hedge timer fired: the request has been in flight for
        hedge_after_s. If its primary attempt still has no first token,
        dispatch ONE duplicate to a different healthy replica — first
        terminal wins, the loser is cancelled. A hedge failure is
        fire-and-forget: it never burns breaker evidence and never
        triggers failover (the primary attempt still owns the request's
        retry budget)."""
        fut = pend.future
        if fut.done() or self._draining.is_set():
            return
        inner = pend.inner
        primary = pend.in_submit or pend.cur_rep
        if inner is None:
            if pend.in_submit is None:
                # between attempts: failover owns it
                return
            # else the dispatcher is BLOCKED in client.submit — a gray
            # accept (delayed/black-holed accepted frame); this is a tail
            # the hedge must cut, not skip
        elif inner.done() or inner._t_first is not None:
            # already terminal, or the first token arrived — the tail
            # this hedge would cut no longer exists
            return
        cands = self._candidates(
            exclude=() if primary is None else (primary,))
        if not cands:
            self._hedge_outcome("suppressed")
            return
        with self._stats_lock:
            budget = max(1.0, self.stats["submitted"]
                         * self.hedge_budget_pct / 100.0)
            if self.stats["hedges"] + 1 > budget:
                suppressed = True
            else:
                suppressed = False
                self.stats["hedges"] += 1
        if suppressed:
            self._hedge_outcome("suppressed")
            return
        rep = min(cands, key=self._load_score)
        kw = dict(pend.kw)
        kw.pop("trace", None)     # one journey cannot ride two live
        #   streams; the hedge is recorded as a router span instead
        if pend.deadline is not None:
            kw["deadline_s"] = max(pend.deadline - time.monotonic(), 1e-3)
        if getattr(rep.client, "supports_req_uid", False):
            kw["req_uid"] = pend.req_uid
        t0 = time.perf_counter()
        try:
            hinner = rep.client.submit(pend.prompt_ids, **kw)
        except Exception as e:
            self._hedge_outcome("failed")
            if pend.trace is not None:
                pend.trace.event("router.hedge", t0=t0, replica=rep.name,
                                 launched=False,
                                 error=f"{type(e).__name__}: {e}"[:200])
            return
        pend.hedge_inner = hinner
        if fut.done():
            hinner.cancel()
            return
        with self._stats_lock:
            rep.inflight += 1
        self._hedge_outcome("launched")
        _flight_record("router", rep.name, event="hedge",
                       req=str(fut._req_id or "?"),
                       primary=str(primary))
        if pend.trace is not None:
            pend.trace.event("router.hedge", t0=t0, replica=rep.name,
                             primary=primary, launched=True)
        hinner._add_done_callback(
            lambda _i, _pend=pend, _rep=rep:
            self._on_hedge_done(_pend, _rep, _i))

    def _on_hedge_done(self, pend: _Pending, rep: _Replica,
                       hinner: GenerationResult) -> None:
        with self._stats_lock:
            rep.inflight = max(0, rep.inflight - 1)
        fut = pend.future
        err = hinner._error
        if fut.done() or pend.delivered:
            # the primary delivered first (and _finish_ok cancelled us),
            # or the client went away — either way this duplicate lost
            self._hedge_outcome(
                "lost" if isinstance(err, RequestCancelledError)
                else "lost" if err is None else "failed")
            return
        if err is None:
            rep.breaker.record_success()
            with self._stats_lock:
                self.stats["hedge_wins"] += 1
            self._hedge_outcome("won")
            if pend.trace is not None:
                pend.trace.event("router.hedge_win", replica=rep.name)
            self._finish_ok(pend, hinner)
            return
        # hedge failed while the primary is still working: drop it on the
        # floor — no failover, no breaker evidence (one duplicate's death
        # must not evict a replica the primary path hasn't judged)
        self._hedge_outcome("failed")

    # -- client API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_token_id=None, deadline_s: Optional[float] = None,
               prefix_len: Optional[int] = None) -> GenerationResult:
        """Route one generation request into the fleet. Raises typed at
        submit exactly like the engine (validation, expired deadline,
        :class:`FleetUnavailableError` when no replica is in rotation);
        infra failures AFTER admission fail over transparently and
        surface only when the retry budget is spent."""
        if self._draining.is_set():
            raise EngineDrainingError(
                "serving router is draining; no new requests admitted")
        self.start()
        fut = GenerationResult()
        fut._req_id = next(_REQ_IDS)
        fut._obs_emit = False   # the replica-side inner future feeds the
        #       SLO histograms + flight ring; the wrapper must not record
        #       the same request twice (slo()/slo_summary still work — the
        #       inner stamps are copied over on delivery)
        deadline = (None if deadline_s is None
                    else time.monotonic() + float(deadline_s))
        fut._deadline = deadline
        prefix_key = None
        if prefix_len:
            arr = np.asarray(prompt_ids, np.int32).reshape(-1)
            prefix_key = arr[: int(prefix_len)].tobytes()
        tr = None
        try:
            from ..observability import reqtrace as _rt

            if _rt.enabled():
                # the journey is minted HERE, at the fleet front door, and
                # crosses the ReplicaClient seam as a submit kwarg — the
                # wrapper future owns it (closes it on delivery); every
                # replica-side stage stamps into the same object
                tr = _rt.mint(fut._req_id)
        except Exception:
            tr = None
        fut._trace = tr
        fut._trace_owner = tr is not None
        kw = {"max_new_tokens": max_new_tokens, "temperature": temperature,
              "top_k": top_k, "eos_token_id": eos_token_id,
              "prefix_len": prefix_len}
        if tr is not None:
            # only when tracing is armed: a foreign replica engine built
            # before the trace kwarg existed keeps working with it off
            kw["trace"] = tr
        pend = _Pending(prompt_ids, kw, fut, deadline, prefix_key)
        pend.trace = tr
        if tr is not None:
            arr = np.asarray(prompt_ids, np.int32).reshape(-1)
            tr.event("submit", replica="router", prompt=int(arr.size),
                     budget=int(max_new_tokens),
                     **({} if deadline_s is None
                        else {"deadline_s": float(deadline_s)}))
        self._bump("submitted")
        # a client cancel must reach the replica currently decoding it
        fut._add_done_callback(
            lambda f, _pend=pend: (_pend.inner.cancel()
                                   if f.cancelled() and _pend.inner is not None
                                   else None))
        self._dispatch(pend, sync=True)
        return fut

    def generate(self, prompt_ids, timeout: float = 300.0,
                 **kw) -> np.ndarray:
        return self.submit(prompt_ids, **kw).result(timeout)

    def health(self) -> Dict[str, object]:
        """Fleet snapshot: the ``router`` block (census + pick/retry/
        failover/eviction counters) plus one per-replica summary of the
        fields picks are made on."""
        reps: Dict[str, object] = {}
        healthy = 0
        for rep in self._replicas:
            snap = rep.snapshot or {}
            ok = (rep.in_rotation and rep.breaker.state != "open"
                  and bool(snap.get("ok", False)))
            healthy += ok
            reps[rep.name] = {
                "ok": ok,
                "in_rotation": rep.in_rotation,
                "breaker": rep.breaker.state,
                "inflight": rep.inflight,
                "est_wait_s": snap.get("est_wait_s"),
                "queue_depth": snap.get("queue_depth"),
                "pages_free": snap.get("pages_free"),
                "generation": rep.client.generation,
            }
            # process-backed replicas (RemoteReplicaClient over a
            # ReplicaSupervisor) carry their supervisor block — pid,
            # spawn/restart/crash counters, last exit — for obsctl
            if snap.get("supervisor") is not None:
                reps[rep.name]["supervisor"] = snap["supervisor"]
        with self._stats_lock:
            stats = dict(self.stats)
        alive = self._started and not self._stop.is_set()
        state = ("draining" if self._draining.is_set() and alive
                 else "serving" if alive else "stopped")
        try:
            from ..observability import reqtrace as _rt

            slo_burn = _rt.burn_snapshot()
        except Exception:
            slo_burn = {"enabled": False}
        return {
            "state": state,
            "ok": alive and not self._draining.is_set() and healthy > 0,
            "router": {"replicas": len(self._replicas), "healthy": healthy,
                       **stats},
            # fleet-level SLO burn rate (sliding window vs FLAGS_slo_*_ms
            # targets): the autoscaler's scale-up/down input signal
            "slo_burn": slo_burn,
            "replicas": reps,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingRouter":
        if self._started and not self._stop.is_set():
            return self
        self._stop.clear()
        self._draining.clear()
        for rep in self._replicas:
            try:
                rep.client.start()
            except Exception:
                pass                  # the prober will keep it evicted
        self._probe_once()
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True, name="router-prober")
        self._prober.start()
        self._retrier = threading.Thread(target=self._retry_loop,
                                         daemon=True, name="router-retrier")
        self._retrier.start()
        self._started = True
        try:
            from ..observability import exporter as _exporter

            served = _exporter.get()
            if served is not None:
                self._health_reg_name = served.register_health(
                    "router", self.health, unique=True)
        except Exception:
            pass
        return self

    def _fail_scheduled(self, err: BaseException) -> int:
        """Fail every pending resubmission waiting in the retry heap —
        drain/stop must leave no future unresolved."""
        with self._retry_cv:
            waiting = [(k, p) for _, _, k, p in self._retry_heap]
            self._retry_heap.clear()
            self._retry_cv.notify()
        n = 0
        for kind, pend in waiting:
            if kind != "retry":
                continue     # a swept hedge timer just never fires: the
                #              primary attempt still resolves the future
            if not pend.future.done():
                self._finish_fail(pend, err)
                n += 1
        return n

    def drain(self, timeout: Optional[float] = None) -> Dict[str, object]:
        """Fleet-wide graceful shutdown: stop admission (submits raise
        :class:`EngineDrainingError`), fail queued resubmissions typed,
        drain every replica (their in-flight requests finish, their queued
        ones shed — and, with admission closed, fail typed rather than
        failing over). Idempotent."""
        timeout = self.drain_timeout_s if timeout is None else timeout
        t0 = time.monotonic()
        self._draining.set()
        shed = self._fail_scheduled(EngineDrainingError(
            "request shed: serving router drained before it was served"))
        clean = True
        for rep in self._replicas:
            try:
                res = rep.client.drain(timeout)
                clean = clean and bool(res.get("clean", True))
                shed += int(res.get("shed", 0))
            except Exception:
                clean = False
        _safe_inc("paddle_router_drains_total", "fleet drains completed",
                  outcome="clean" if clean else "timeout")
        return {"clean": clean, "shed": shed,
                "wall_s": round(time.monotonic() - t0, 3)}

    def stop(self) -> None:
        self._draining.set()
        self._fail_scheduled(RuntimeError("serving router stopped"))
        self._stop.set()
        with self._retry_cv:
            self._retry_cv.notify()
        for t in (self._prober, self._retrier):
            if t is not None:
                t.join(timeout=5)
        self._prober = self._retrier = None
        self._started = False
        for rep in self._replicas:
            rep.client.stop()
        try:
            from ..observability import exporter as _exporter

            served = _exporter.get()
            if served is not None:
                served.unregister_health(
                    self._health_reg_name or "router", fn=self.health)
        except Exception:
            pass

    def __enter__(self) -> "ServingRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- elastic membership --------------------------------------------------
    def _free_name(self) -> str:
        taken = {r.name for r in self._replicas}
        i = len(self._replicas)
        while f"r{i}" in taken:
            i += 1
        return f"r{i}"

    def add_replica(self, replica, name: Optional[str] = None) -> str:
        """Join one replica to the rotation under live traffic. ``replica``
        is a ready :class:`ReplicaClient` (the fleet controller hands one
        in already started and PRE-WARMED, so its first routed request
        never lands on a cold program) or a zero-arg engine factory.
        Rendezvous-hashed prefix keys move ONLY onto the joining replica —
        every other prefix keeps its home — so the fleet-wide cache hit
        rate survives a scale-up. Returns the replica name."""
        client = replica if isinstance(replica, ReplicaClient) \
            else ReplicaClient(replica, name=name or self._free_name())
        if any(r.name == client.name for r in self._replicas):
            raise ValueError(f"replica name {client.name!r} already "
                             "in the rotation")
        rep = self._make_replica(client)
        if self._started and not self._stop.is_set():
            try:
                client.start()
            except Exception:
                pass              # the probe below keeps it out of picks
            try:
                rep.snapshot = rep.client.health()
            except Exception:
                rep.snapshot = None
        self._replicas = self._replicas + [rep]     # atomic snapshot swap
        self._bump("replicas_added")
        _safe_inc("paddle_router_replicas_added_total",
                  "replicas joined to the rotation", replica=rep.name)
        _flight_record("router", rep.name, event="add")
        return client.name

    def remove_replica(self, name: str,
                       drain_timeout: Optional[float] = None,
                       stop: bool = True,
                       reason: str = "scale_down") -> Dict[str, object]:
        """Leave the rotation DELIBERATELY (scale-down): the replica stops
        receiving picks, drains (in-flight finishes; queued sheds fail
        over to the rest — none of it is breaker failure evidence), is
        removed from the pick set (rendezvous keys it owned redistribute;
        nobody else's move), and — unless ``stop=False`` — its engine is
        stopped, which unregisters its ``/healthz`` provider. The router-
        side breaker/prober state is dropped with the replica, so a later
        replica reusing the name starts with a clean slate. Returns the
        drain summary plus the final breaker state."""
        rep = self._replica(name)
        if len(self._replicas) <= 1:
            raise ValueError("cannot remove the last replica; drain() or "
                             "stop() the router instead")
        rep.in_rotation = False    # no new picks; the prober stops feeding
        #                            its breaker (deliberate, not sickness)
        drain_timeout = (self.drain_timeout_s if drain_timeout is None
                         else drain_timeout)
        clean, shed = True, 0
        try:
            res = rep.client.drain(drain_timeout, reason=reason)
            clean = bool(res.get("clean", True))
            shed = int(res.get("shed", 0))
        except Exception:
            clean = False
        self._replicas = [r for r in self._replicas if r is not rep]
        if stop:
            try:
                rep.client.stop()   # unregisters the /healthz provider
            except Exception:
                pass
        self._bump("replicas_removed")
        _safe_inc("paddle_router_replicas_removed_total",
                  "replicas removed from the rotation, by reason",
                  replica=rep.name, reason=reason)
        _flight_record("router", rep.name, event="remove", reason=reason,
                       clean=clean, shed=shed)
        return {"replica": name, "clean": clean, "shed": shed,
                "breaker": rep.breaker.state,
                "generation": rep.client.generation}

    # -- rolling restart -----------------------------------------------------
    def restart_replica(self, replica, drain_timeout: Optional[float] = None,
                        health_timeout: float = 60.0, warmup: bool = True,
                        factory: Optional[Callable] = None,
                        readmit: bool = True) -> Dict[str, object]:
        """One replica's zero-downtime replacement cycle — the unit both
        :meth:`rolling_restart` and the fleet controller's deploy rollout
        are built from: out of rotation → drain (queued requests fail over
        to the rest) → fresh engine (``factory`` swaps the build recipe:
        a deploy hands in the candidate-bundle factory, a rollback the
        previous one) → pre-warm while still out of rotation → health
        gate → breaker reset + re-admission. On a failed health gate the
        replica is LEFT out of rotation and ``ok`` is False — the caller
        decides between abort (rolling restart) and rollback (deploy).
        ``readmit=False`` keeps a HEALTHY replica out of rotation too: the
        deploy pipeline probes its canary before letting it take traffic."""
        rep = replica if isinstance(replica, _Replica) \
            else self._replica(replica)
        t0 = time.monotonic()
        _flight_record("router", rep.name, event="rolling_restart",
                       phase="begin")
        rep.in_rotation = False
        if factory is not None:
            rep.client.restart(drain_timeout, factory=factory)
        else:
            # positional form: keeps drop-in ReplicaClient substitutes
            # (and test doubles) with the pre-deploy signature working
            rep.client.restart(drain_timeout)
        warm_info = None
        if warmup:
            # compiles happen HERE, outside rotation — not on the
            # first unlucky routed request after re-admission
            try:
                warm_info = rep.client.warmup()
                _safe_inc("paddle_router_prewarms_total",
                          "replicas pre-warmed during rolling restart",
                          replica=rep.name)
                _flight_record("router", rep.name, event="prewarm",
                               **(warm_info or {}))
            except Exception as e:
                # warm-later is degraded, not fatal: the health gate
                # below still decides re-admission
                sys.stderr.write(
                    f"[router] replica {rep.name} pre-warm failed "
                    f"({type(e).__name__}: {e}); first requests may "
                    "pay compiles\n")
        deadline = time.monotonic() + health_timeout
        ok = False
        while time.monotonic() < deadline:
            try:
                snap = rep.client.health()
                ok = bool(snap.get("ok", False))
            except Exception:
                ok = False
            if ok:
                rep.snapshot = snap
                break
            time.sleep(0.02)
        if ok and readmit:
            # fresh engine: forget the old one's failure history so the
            # replica is immediately pickable, not half-open-gated
            rep.breaker.reset()
            rep.in_rotation = True
        _flight_record("router", rep.name, event="rolling_restart",
                       phase="end", ok=ok)
        return {"replica": rep.name, "ok": ok,
                "generation": rep.client.generation,
                "warmup": warm_info,
                "wall_s": round(time.monotonic() - t0, 3)}

    def rolling_restart(self, drain_timeout: Optional[float] = None,
                        health_timeout: float = 60.0,
                        warmup: bool = True) -> Dict[str, object]:
        """Restart every replica one at a time without dropping traffic:
        take it out of rotation (no new picks), drain it (in-flight
        finishes; queued requests shed typed and fail over to the rest),
        build a fresh engine, PRE-WARM its compile plan while it is still
        out of rotation (``warmup=False`` skips it — e.g. replicas that
        load a bundle and warm themselves at boot), wait until its
        health probe reads ok, put it back. The first request routed to
        the restarted replica therefore never lands on a cold program.
        Stops early — replica left OUT of rotation — if a restarted
        replica never turns healthy, so a bad deploy cannot take the whole
        fleet down one "upgrade" at a time."""
        self.start()
        drain_timeout = (self.drain_timeout_s if drain_timeout is None
                         else drain_timeout)
        rounds = []
        all_ok = True
        for rep in list(self._replicas):
            round_info = self.restart_replica(
                rep, drain_timeout=drain_timeout,
                health_timeout=health_timeout, warmup=warmup)
            rounds.append(round_info)
            if not round_info["ok"]:
                all_ok = False
                sys.stderr.write(
                    f"[router] rolling restart ABORTED: replica {rep.name} "
                    f"did not turn healthy within {health_timeout:g}s — "
                    "left out of rotation, remaining replicas not "
                    "restarted\n")
                break
        self._bump("rolling_restarts")
        _safe_inc("paddle_router_rolling_restarts_total",
                  "fleet rolling restarts", outcome="ok" if all_ok
                  else "aborted")
        return {"ok": all_ok, "replicas": rounds}
