"""Request-journey tracing — ONE stitched trace per serving request, from
the router's replica pick to the last decoded token.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
reqtrace.py``, unchanged. The port's ``ServingEngine`` mints and closes the
journeys and its engine stamps the reference's spans (queue wait, admit,
first token, each decode chunk, speculative rounds); the router, the
replica seam and ``obsctl`` arrive with the fleet (ROADMAP A7).

The serving stack emits plenty of per-process telemetry (SLO histograms,
per-replica flight events, program rooflines) but before this module no
single artifact showed what happened to *one request*: the SLO stamps are
four timestamps on a future, and the span rings are per-process with no
request identity crossing the ``ReplicaClient`` seam. Production tracing
(Dapper-style context propagation; vLLM's per-request step logs) treats
the request-scoped trace as the debugging primitive a fleet lives on —
"TTFT p99 spiked" must resolve to actual journeys, not to a histogram
bucket.

Model
-----

* A **journey** is minted at ``ServingRouter.submit()`` (or directly at
  ``ServingEngine.submit()`` for router-less engines) and travels with
  the request: the router passes it through the ``ReplicaClient`` seam as
  a ``submit(..., trace=...)`` kwarg, the engine attaches it to the
  request's result future, and every stage stamps typed **spans** into
  it — router pick (with candidate scores), backoff waits, per-attempt
  child spans (replica id + failure cause on the failed ones), submit-
  time rejections, per-attempt queue wait, paged admission (bucket,
  pages reserved, prefix HIT/MISS), every decode chunk, speculative
  draft/verify rounds (k, steps, accepted), first token, finish.
* Spans are plain dicts ``{name, t, dur, replica, ...attrs}`` with ``t``
  (start) and ``dur`` in seconds relative to the journey's mint time —
  bounded per journey (``FLAGS_obs_reqtrace_spans``; overflow counts
  into ``dropped_spans`` instead of growing).
* Completed journeys move from the in-flight map into a bounded ring
  (``FLAGS_obs_reqtrace_ring``); nothing references futures or token
  arrays, so the ring pins no device memory and a soak leaves zero
  in-flight residue.

Four read surfaces:

* ``/requests`` on the telemetry exporter — recent + in-flight journeys
  as strict JSON, plus the SLO-histogram exemplars below;
  ``/requests/trace`` — the same journeys as chrome-trace JSON (load in
  Perfetto: one process per request, one track per replica).
* ``tools/obsctl.py requests`` — journey table, per-journey waterfall
  with the TTFT/TPOT breakdown, ``--perfetto`` export.
* **Histogram exemplars** — the slowest recent requests per SLO metric
  (TTFT / TPOT / queue wait), each carrying its ``trace_id`` and the
  histogram bucket bound it landed in, so a p99 spike resolves to real
  journeys.
* **Flight recorder** — the black box annotates every dump with the
  journeys in flight at crash time.

Independently of tracing, this module computes the **SLO burn-rate
gauges** the autoscaler control loop (ROADMAP item 5) needs:
``paddle_slo_burn_{ttft,tpot}`` — sliding-window violation rate against
``FLAGS_slo_ttft_ms``/``FLAGS_slo_tpot_ms`` targets divided by the error
budget (``FLAGS_slo_error_budget``, default 1% — burn 1.0 = exactly
spending the budget, >1 = burning it down). Surfaced in every serving
``health()`` as the ``slo_burn`` block.

Everything is OFF by default (``PADDLE_OBS_REQTRACE=1`` /
``FLAGS_obs_reqtrace`` arms tracing; the burn gauges arm themselves when
a target flag is nonzero). The off cost on the serve path is one
``None`` attribute check per seam — ``tools/check_obs_overhead.py``
gates it under the same 5% budget as the rest of the obs family.
"""

from __future__ import annotations

import itertools
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional

from ..core import flags as _flags
from .metrics import LATENCY_BUCKETS

__all__ = [
    "Journey", "enable", "disable", "enabled", "reset", "mint",
    "finish", "finish_future", "slo_observe", "burn_snapshot", "journeys",
    "inflight", "get", "exemplars", "requests_jsonable", "to_chrome_trace",
]

_TRACE_IDS = itertools.count(1)
_lock = threading.Lock()          # registry + exemplar mutations only;
#   span appends ride the GIL (list.append is atomic) like the flight ring

_on = False
_ring: deque = deque(maxlen=256)              # completed journeys
_inflight: Dict[str, "Journey"] = {}          # trace_id -> Journey
_max_spans = 256

# slowest-request exemplars per SLO histogram: metric -> sorted (desc by
# value) list of {"value_s", "le", "trace_id", "req_id"}
_EXEMPLAR_N = 5
_METRIC_HIST = {
    "ttft": "paddle_serving_ttft_seconds",
    "tpot": "paddle_serving_tpot_seconds",
    "queue_wait": "paddle_serving_queue_wait_seconds",
}
_exemplars: Dict[str, List[dict]] = {m: [] for m in _METRIC_HIST}


class Journey:
    """One request's stitched trace. Span appends are GIL-atomic list
    appends; readers snapshot with ``list(...)`` — the same discipline as
    the flight ring, so stamping never takes a lock on the serve path."""

    __slots__ = ("trace_id", "req_id", "t0", "t0_wall", "spans", "dropped",
                 "done", "outcome", "replica", "attempts", "replicas",
                 "slo", "max_spans")

    def __init__(self, req_id, max_spans: int):
        self.trace_id = f"j{next(_TRACE_IDS)}-r{req_id}"
        self.req_id = req_id
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.spans: List[dict] = []
        self.dropped = 0
        self.done = False
        self.outcome: Optional[str] = None
        self.replica: Optional[str] = None    # current attempt's replica:
        #   engine-side spans inherit it, so every span lands on the track
        #   of the replica that produced it
        self.attempts = 0
        self.replicas: List[str] = []         # attempt order, with repeats
        self.slo: Optional[dict] = None
        self.max_spans = max_spans

    # -- write side ----------------------------------------------------------
    def event(self, name: str, t0: Optional[float] = None,
              t1: Optional[float] = None, replica: Optional[str] = None,
              **attrs) -> None:
        """Record one span: ``t0``/``t1`` are absolute ``perf_counter``
        stamps (both default to now — a zero-duration point event)."""
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        now = time.perf_counter()
        start = now if t0 is None else t0
        end = start if t1 is None else t1
        span = {"name": name,
                "t": round(start - self.t0, 6),
                "dur": round(max(end - start, 0.0), 6)}
        rep = replica if replica is not None else self.replica
        if rep is not None:
            span["replica"] = rep
        if attrs:
            span.update(attrs)
        self.spans.append(span)

    def set_replica(self, name: str) -> None:
        """The router's pick: subsequent engine-side spans (queue wait,
        admission, decode chunks) attribute to this replica's track."""
        self.replica = name
        self.attempts += 1
        self.replicas.append(name)

    # -- read side -----------------------------------------------------------
    def jsonable(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "req_id": self.req_id,
            "t0_wall": round(self.t0_wall, 6),
            "done": self.done,
            "outcome": self.outcome,
            "attempts": self.attempts,
            "replicas": list(self.replicas),
            "slo": self.slo,
            "dropped_spans": self.dropped,
            "spans": list(self.spans),
        }


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return _on


def enable(ring: Optional[int] = None,
           max_spans: Optional[int] = None) -> None:
    """Arm request-journey tracing (idempotent; re-enable swaps the ring
    capacity). Also annotates the flight recorder so crash dumps carry
    the journeys in flight at the moment of death."""
    global _on, _ring, _max_spans
    cap = int(ring if ring is not None
              else _flags.flag_value("obs_reqtrace_ring"))
    spans = int(max_spans if max_spans is not None
                else _flags.flag_value("obs_reqtrace_spans"))
    with _lock:
        _ring = deque(_ring, maxlen=max(cap, 4))
        _max_spans = max(spans, 8)
        _on = True
    _flags.set_flags({"obs_reqtrace": True})
    try:
        from . import flight

        flight.annotate("reqtrace_inflight", _inflight_annotation)
    except Exception:
        pass


def disable() -> None:
    """Disarm tracing. Recorded journeys are kept (``reset()`` drops
    them); in-flight requests minted before the disable still finish
    their journeys — a trace must not lose its tail mid-request."""
    global _on
    _on = False
    _flags.set_flags({"obs_reqtrace": False})


def reset() -> None:
    """Drop every journey, exemplar and burn-window sample."""
    with _lock:
        _ring.clear()
        _inflight.clear()
        for rows in _exemplars.values():
            rows.clear()
    _burn.reset()


def _inflight_annotation():
    """Flight-recorder header at dump time: what every in-flight request
    was doing when the process died (bounded — a crash dump is not a
    database)."""
    with _lock:
        live = list(_inflight.values())[:32]
    return [j.jsonable() for j in live]


# ---------------------------------------------------------------------------
# write API (called from the serving seams)
# ---------------------------------------------------------------------------

def mint(req_id) -> Optional[Journey]:
    """Start a journey for one request (None when tracing is off — the
    serve path's entire off cost is this check plus carrying a None)."""
    if not _on:
        return None
    j = Journey(req_id, _max_spans)
    with _lock:
        _inflight[j.trace_id] = j
    return j


def _finish(j: Journey, outcome: str, slo: Optional[dict] = None) -> None:
    if j.done:
        return
    j.done = True
    j.outcome = outcome
    if slo is not None:
        j.slo = {k: (None if v is None else round(v, 6) if
                     isinstance(v, float) else v) for k, v in slo.items()}
    j.event("finish", outcome=outcome,
            **({} if not slo else
               {"tokens": slo.get("new_tokens")}))
    with _lock:
        _inflight.pop(j.trace_id, None)
        # exemplars must stay JOINABLE: drop rows whose journey just got
        # evicted from the ring, or the "slowest recent" lists would pin
        # all-time maxima whose trace_ids dangle (and block genuinely
        # recent slow requests from ever entering). Rows are only ever
        # added for ring members (finish_future, after the append), so
        # pruning the one evicted id keeps the invariant at O(1).
        evicted = (_ring[0].trace_id
                   if len(_ring) == _ring.maxlen else None)
        _ring.append(j)
        if evicted is not None:
            for rows in _exemplars.values():
                rows[:] = [r for r in rows if r["trace_id"] != evicted]


def finish(j: Journey, outcome: str) -> None:
    """Close a journey that has no owning future. The fleet control plane
    mints these for its ``fleet.scale`` / ``fleet.rollout`` spans — a
    scale decision or a deploy reads in the same waterfall/Perfetto
    surfaces as the requests it was taken for."""
    _finish(j, outcome)


def finish_future(j: Journey, fut, outcome: str) -> None:
    """Close a journey from its owning future's ``_set``: stitch the SLO
    numbers in, move it to the ring, and feed the slowest-request
    exemplars."""
    try:
        slo = fut.slo()
    except Exception:
        slo = None
    _finish(j, outcome, slo)
    if outcome == "ok" and slo is not None:
        for metric, key in (("ttft", "ttft_s"), ("tpot", "tpot_s"),
                            ("queue_wait", "queue_wait_s")):
            v = slo.get(key)
            if v is not None:
                _note_exemplar(metric, float(v), j.trace_id, j.req_id)


# ---------------------------------------------------------------------------
# histogram exemplars
# ---------------------------------------------------------------------------

def _bucket_le(v: float) -> str:
    """The SLO histograms' bucket bound this value lands in (same
    LATENCY_BUCKETS + le semantics as metrics.Histogram.observe)."""
    idx = bisect_left(LATENCY_BUCKETS, v)
    return ("+Inf" if idx >= len(LATENCY_BUCKETS)
            else f"{LATENCY_BUCKETS[idx]:g}")


def _note_exemplar(metric: str, value_s: float, trace_id: str,
                   req_id) -> None:
    row = {"value_s": round(value_s, 6), "le": _bucket_le(value_s),
           "trace_id": trace_id, "req_id": req_id}
    with _lock:
        rows = _exemplars[metric]
        rows.append(row)
        rows.sort(key=lambda r: -r["value_s"])
        del rows[_EXEMPLAR_N:]


def exemplars() -> Dict[str, dict]:
    """Slowest recent requests per SLO histogram — the join from "TTFT
    p99 spiked" to the actual journeys (`trace_id` resolves via
    ``get()`` / ``/requests``)."""
    with _lock:
        return {hist: {"metric": metric, "slowest": [dict(r) for r in
                                                     _exemplars[metric]]}
                for metric, hist in _METRIC_HIST.items()}


# ---------------------------------------------------------------------------
# SLO burn rate (autoscaler input — independent of tracing)
# ---------------------------------------------------------------------------

class _BurnTracker:
    """Sliding-window SLO violation rate over the same per-request stamps
    that feed the TTFT/TPOT histograms. ``burn = violation_rate /
    error_budget`` — the multi-window burn-rate alerting form (SRE
    workbook ch.5): 1.0 means the fleet is spending its error budget
    exactly as fast as it accrues."""

    def __init__(self):
        self._lock = threading.Lock()
        self._win: deque = deque()   # (monotonic, ttft_viol, tpot_viol);
        #   viol is None when that stamp was unavailable for the request
        # running window counters ([samples, violations] per metric),
        # incremented on append and decremented on evict — observe() and
        # snapshot() stay O(evicted), never O(window), so a high-QPS
        # delivery thread is not re-summing 30k rows per request
        self._counts = {"ttft": [0, 0], "tpot": [0, 0]}

    def reset(self) -> None:
        with self._lock:
            self._win.clear()
            self._counts = {"ttft": [0, 0], "tpot": [0, 0]}

    @staticmethod
    def targets():
        return (_flags.flag_value("slo_ttft_ms"),
                _flags.flag_value("slo_tpot_ms"))

    def _prune(self, now: float) -> None:
        """Evict aged-out samples, rolling the counters back (lock
        held)."""
        cut = now - _flags.flag_value("slo_burn_window_s")
        while self._win and self._win[0][0] < cut:
            _, tv, pv = self._win.popleft()
            for key, v in (("ttft", tv), ("tpot", pv)):
                if v is not None:
                    c = self._counts[key]
                    c[0] -= 1
                    c[1] -= int(v)

    def observe(self, ttft_s: Optional[float],
                tpot_s: Optional[float]) -> None:
        ttft_ms, tpot_ms = self.targets()
        if ttft_ms <= 0 and tpot_ms <= 0:
            return                    # burn gauges disarmed: zero work
        now = time.monotonic()
        tv = (None if (ttft_ms <= 0 or ttft_s is None)
              else ttft_s * 1e3 > ttft_ms)
        pv = (None if (tpot_ms <= 0 or tpot_s is None)
              else tpot_s * 1e3 > tpot_ms)
        with self._lock:
            self._win.append((now, tv, pv))
            for key, v in (("ttft", tv), ("tpot", pv)):
                if v is not None:
                    c = self._counts[key]
                    c[0] += 1
                    c[1] += int(v)
            self._prune(now)
        snap = self.snapshot()
        from . import safe_set as _safe_set

        for key, gauge in (("ttft", "paddle_slo_burn_ttft"),
                           ("tpot", "paddle_slo_burn_tpot")):
            block = snap.get(key)
            if block and block.get("burn") is not None:
                _safe_set(gauge,
                          f"sliding-window {key.upper()} SLO burn rate "
                          "(violation rate / error budget; >1 = burning "
                          "the budget down)", block["burn"])

    def snapshot(self) -> dict:
        ttft_ms, tpot_ms = self.targets()
        if ttft_ms <= 0 and tpot_ms <= 0:
            return {"enabled": False}
        budget = max(float(_flags.flag_value("slo_error_budget")), 1e-9)
        window = _flags.flag_value("slo_burn_window_s")
        with self._lock:
            self._prune(time.monotonic())
            total = len(self._win)
            counts = {k: tuple(v) for k, v in self._counts.items()}
        out = {"enabled": True, "window_s": window,
               "error_budget": budget, "requests": total}
        for key, target in (("ttft", ttft_ms), ("tpot", tpot_ms)):
            if target <= 0:
                out[key] = {"enabled": False}
                continue
            seen, viol = counts[key]
            rate = (viol / seen) if seen else None
            out[key] = {
                "enabled": True,
                "target_ms": target,
                "requests": seen,
                "violations": viol,
                "violation_rate": (None if rate is None
                                   else round(rate, 4)),
                "burn": (None if rate is None
                         else round(rate / budget, 4)),
            }
        return out


_burn = _BurnTracker()


def slo_observe(ttft_s: Optional[float], tpot_s: Optional[float]) -> None:
    """Feed one completed request's stamps into the burn window (no-op
    unless a ``FLAGS_slo_*_ms`` target is armed)."""
    _burn.observe(ttft_s, tpot_s)


def burn_snapshot() -> dict:
    """The ``slo_burn`` block of serving/router ``health()`` — the input
    signal the SLO-driven autoscaler (ROADMAP item 5) closes its loop
    on."""
    return _burn.snapshot()


# ---------------------------------------------------------------------------
# read API
# ---------------------------------------------------------------------------

def journeys() -> List[Journey]:
    """Completed journeys, oldest first."""
    with _lock:
        return list(_ring)


def inflight() -> List[Journey]:
    with _lock:
        return list(_inflight.values())


def get(trace_id: str) -> Optional[Journey]:
    with _lock:
        j = _inflight.get(trace_id)
        if j is not None:
            return j
        for j in _ring:
            if j.trace_id == trace_id:
                return j
    return None


def requests_jsonable() -> dict:
    """The ``/requests`` endpoint body: strict JSON, newest-first."""
    with _lock:
        recent = [j.jsonable() for j in reversed(_ring)]
        live = [j.jsonable() for j in _inflight.values()]
    return {
        "enabled": _on,
        "ring_capacity": _ring.maxlen,
        "inflight_count": len(live),
        "inflight": live,
        "journeys": recent,
        "exemplars": exemplars(),
        "slo_burn": burn_snapshot(),
    }


def to_chrome_trace(journey_list: Optional[List[Journey]] = None) -> dict:
    """Journeys as trace-event JSON (Perfetto/chrome://tracing): one
    process (pid) per request, one thread (track) per replica — a
    failover reads as the request hopping tracks, with the failure cause
    in the failed attempt's args."""
    if journey_list is None:
        journey_list = journeys() + inflight()
    events = []
    for pid, j in enumerate(journey_list, start=1):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"request {j.trace_id} "
                                        f"({j.outcome or 'in-flight'})"}})
        tids: Dict[str, int] = {}
        base_us = j.t0_wall * 1e6
        for span in list(j.spans):
            rep = span.get("replica") or "router"
            tid = tids.get(rep)
            if tid is None:
                tid = tids[rep] = len(tids) + 1
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": rep}})
            args = {k: v for k, v in span.items()
                    if k not in ("name", "t", "dur", "replica")}
            events.append({
                "ph": "X", "pid": pid, "tid": tid,
                "name": span["name"],
                "ts": round(base_us + span["t"] * 1e6, 3),
                "dur": round(max(span["dur"] * 1e6, 1.0), 3),
                "cat": "request",
                "args": args,
            })
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"source": "paddlepaddle_tpu reqtrace",
                         "journeys": len(journey_list)}}
