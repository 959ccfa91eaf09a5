"""In-process metric history: bounded per-series rings over the registry.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
tsdb.py``, unchanged but for where it starts: nothing runs at import;
``observability.enable_history()`` (or :func:`enable`) arms it. Under a
launched job each rank's ``FleetPublisher`` (:mod:`~.aggregate`) publishes
this history, and rank 0 serves every rank's at ``/fleet/query``.

Every other surface in the observability family answers "what is the value
*now*" — ``/metrics`` is an instantaneous scrape, ``/healthz`` a live
census.  This module adds *history* without an external Prometheus: a
sampler thread diffs successive :meth:`metrics.Registry.snapshot` outputs
every ``FLAGS_obs_tsdb_interval_s`` and appends one point per series into a
bounded ring.

Series model
------------
* **Counters** are stored as *rates* (delta / dt per sampling interval) —
  the only shape a window aggregate is meaningful over.  A counter reset
  (registry ``clear()``, process restart) yields a negative delta, which is
  dropped rather than recorded as a huge negative rate.
* **Gauges** are stored as sampled values.
* **Histograms** become derived series per label set: ``name:p50`` /
  ``name:p99`` (window quantile estimated from the bucket-count deltas of
  the interval), ``name:rate`` (observations/s) and ``name:mean`` (window
  mean = dsum/dcount).  Intervals with no new observations produce no
  points (a gap, not a zero).

Series ids are ``name{label="value",...}`` with the derived suffix before
the label block (``paddle_serving_ttft_seconds:p99{...}``).

Retention: two tiers per series — a raw ring of ``FLAGS_obs_tsdb_points``
points at the sampling interval, plus a 10x coarser ring of the same
capacity where every 10 raw points collapse to one ``(t, mean, min, max)``
aggregate.  At the defaults (512 points, 2s interval) that is ~17 minutes
raw + ~2.8 hours coarse per series for a fixed byte budget.

Surfaces: the exporter serves ``/query?series=&window=`` (strict JSON) from
the singleton here; :mod:`~.aggregate` publishes :meth:`MetricHistory.
jsonable` under ``obs/tsdb/rank{r}`` TCPStore keys so rank-0
``/fleet/query`` answers across replicas; :mod:`~.alerts` evaluates its
rules against :meth:`MetricHistory.window_agg` on every sampler tick.

Everything is off until armed; all sampling work rides the daemon thread,
never a serving hot path.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import Registry, _fmt_labels

__all__ = [
    "MetricHistory", "SeriesRing", "enable", "disable", "get", "reset",
    "match_series", "DOWNSAMPLE",
]

#: raw points folded into one coarse point (the "10x coarser" second tier).
DOWNSAMPLE = 10

#: window quantiles derived per histogram label set on every sample.
QUANTILES = (0.5, 0.99)


def _flag(name, default):
    try:
        from ..core import flags as _flags

        v = _flags.flag_value(name)
        return default if v is None else v
    except Exception:
        return default


class SeriesRing:
    """Bounded two-tier point store for ONE series.

    Raw tier: ``(t, value)`` pairs at the sampling interval.  Coarse tier:
    every :data:`DOWNSAMPLE` raw appends collapse into one ``(t, mean, min,
    max)`` aggregate stamped at the last raw point's time.  Both tiers are
    ``deque(maxlen=capacity)`` so memory is fixed at construction.
    """

    __slots__ = ("kind", "raw", "coarse", "_pending")

    def __init__(self, kind: str, capacity: int):
        self.kind = kind
        self.raw: deque = deque(maxlen=max(2, int(capacity)))
        self.coarse: deque = deque(maxlen=max(2, int(capacity)))
        self._pending: List[Tuple[float, float]] = []

    def append(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        self._pending.append((t, v))
        if len(self._pending) >= DOWNSAMPLE:
            vals = [p[1] for p in self._pending]
            self.coarse.append((self._pending[-1][0], sum(vals) / len(vals),
                                min(vals), max(vals)))
            self._pending = []

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> Tuple[str, List[Tuple]]:
        """``(tier, points)`` best answering ``window_s`` seconds of
        history: raw while the window fits inside the raw span, else
        coarse (whose points re-emit as ``(t, mean)`` pairs plus their
        min/max for tier-aware aggregation)."""
        if not self.raw:
            return "raw", []
        if now is None:
            now = self.raw[-1][0]
        if window_s is None:
            return "raw", list(self.raw)
        cutoff = now - window_s
        if self.raw[0][0] <= cutoff or not self.coarse:
            return "raw", [p for p in self.raw if p[0] >= cutoff]
        return "coarse", [p for p in self.coarse if p[0] >= cutoff]

    def window_agg(self, window_s: float, agg: str,
                   now: Optional[float] = None) -> Optional[float]:
        """Aggregate over the window; ``None`` when no points fall in it.
        On the coarse tier ``min``/``max`` use the per-point extrema so
        downsampling cannot hide a spike the raw ring has already
        forgotten."""
        tier, pts = self.points(window_s, now)
        if not pts:
            return None
        if agg == "last":
            return float(pts[-1][1])
        if tier == "coarse":
            means = [p[1] for p in pts]
            if agg == "avg":
                return float(sum(means) / len(means))
            if agg == "min":
                return float(min(p[2] for p in pts))
            if agg == "max":
                return float(max(p[3] for p in pts))
            if agg == "sum":
                return float(sum(means))
        else:
            vals = [p[1] for p in pts]
            if agg == "avg":
                return float(sum(vals) / len(vals))
            if agg == "min":
                return float(min(vals))
            if agg == "max":
                return float(max(vals))
            if agg == "sum":
                return float(sum(vals))
        raise ValueError(f"unknown agg {agg!r}")


def match_series(ids: Sequence[str], selector: Optional[str]) -> List[str]:
    """Selector semantics shared by the live store and the fleet merge:
    ``None``/empty -> every series; trailing ``*`` -> id prefix; else exact
    id, falling back to "name part" (id up to ``{``) so ``paddle_x`` finds
    every label variant and ``paddle_x:p99`` every labeled p99 series."""
    ids = sorted(ids)
    if not selector:
        return ids
    if selector.endswith("*"):
        pre = selector[:-1]
        return [s for s in ids if s.startswith(pre)]
    if selector in ids:
        return [selector]
    return [s for s in ids if s.split("{", 1)[0] == selector]


def _window_quantile(dcounts: Dict[float, int], q: float) -> Optional[float]:
    """Quantile estimate from per-window (non-cumulative) bucket deltas:
    walk ascending bounds until the target rank is covered and report that
    bucket's upper bound — same le-semantics as ``Histogram.quantile`` but
    over the window's observations only.  The +Inf bucket reports the
    largest finite bound (the best upper estimate the data carries)."""
    total = sum(dcounts.values())
    if total <= 0:
        return None
    bounds = sorted(dcounts)
    target = q * total
    seen = 0
    last_finite = None
    for b in bounds:
        if b != float("inf"):
            last_finite = b
        seen += dcounts[b]
        if seen >= target:
            return b if b != float("inf") else last_finite
    return last_finite


class MetricHistory:
    """Snapshot-diffing sampler over a :class:`metrics.Registry`.

    ``observe()`` is one sampling pass (tests drive it directly with a
    synthetic clock); ``start()`` runs it on a daemon thread every
    ``interval_s``.  Listeners (the alert engine) run at the end of each
    pass, on the sampler thread.
    """

    def __init__(self, registry: Registry, interval_s: Optional[float] = None,
                 capacity: Optional[int] = None):
        self.registry = registry
        self.interval_s = float(interval_s if interval_s is not None
                                else _flag("obs_tsdb_interval_s", 2.0))
        self.capacity = int(capacity if capacity is not None
                            else _flag("obs_tsdb_points", 512))
        self._series: Dict[str, SeriesRing] = {}
        self._prev: Dict[Tuple[str, tuple], Tuple[float, object]] = {}
        self._listeners: List[Callable] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    # -- sampling ------------------------------------------------------------
    def _ring(self, sid: str, kind: str) -> SeriesRing:
        r = self._series.get(sid)
        if r is None:
            r = self._series[sid] = SeriesRing(kind, self.capacity)
        return r

    def observe(self, now: Optional[float] = None) -> int:
        """One sampling pass: diff the registry snapshot against the
        previous pass and append one point per live series.  Returns the
        number of points appended."""
        if now is None:
            now = time.time()
        snap = self.registry.snapshot()
        appended = 0
        with self._lock:
            for name, per_key in snap.items():
                metric = self.registry.get(name)
                kind = getattr(metric, "kind", "gauge")
                for key, val in per_key.items():
                    appended += self._observe_one(name, key, kind, val, now)
            self.samples += 1
        for fn in list(self._listeners):
            try:
                fn(self, now)
            except Exception:
                pass
        return appended

    def _observe_one(self, name, key, kind, val, now) -> int:
        labels = _fmt_labels(key)
        pkey = (name, key)
        prev = self._prev.get(pkey)
        self._prev[pkey] = (now, val if kind != "histogram"
                            else {"count": val["count"], "sum": val["sum"],
                                  "buckets": dict(val["buckets"])})
        if kind == "gauge":
            self._ring(f"{name}{labels}", "gauge").append(now, float(val))
            return 1
        if kind == "counter":
            if prev is None:
                return 0
            pt, pv = prev
            dt = now - pt
            dv = float(val) - float(pv)
            if dt <= 0 or dv < 0:   # reset or clock skew: drop the interval
                return 0
            self._ring(f"{name}{labels}", "rate").append(now, dv / dt)
            return 1
        # histogram: window deltas -> rate / mean / quantiles
        if prev is None:
            return 0
        pt, pv = prev
        dt = now - pt
        dcount = val["count"] - pv["count"]
        if dt <= 0 or dcount < 0:
            return 0
        n = 0
        self._ring(f"{name}:rate{labels}", "rate").append(now, dcount / dt)
        n += 1
        if dcount == 0:
            return n   # no new observations: quantiles/mean get a gap
        dsum = val["sum"] - pv["sum"]
        self._ring(f"{name}:mean{labels}", "gauge").append(now, dsum / dcount)
        n += 1
        dbuckets = {b: c - pv["buckets"].get(b, 0)
                    for b, c in val["buckets"].items()}
        for q in QUANTILES:
            est = _window_quantile(dbuckets, q)
            if est is not None:
                sid = f"{name}:p{int(q * 100)}{labels}"
                self._ring(sid, "gauge").append(now, float(est))
                n += 1
        return n

    # -- listeners / thread --------------------------------------------------
    def add_listener(self, fn: Callable) -> None:
        """``fn(history, now)`` after every pass, on the sampler thread."""
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def start(self) -> "MetricHistory":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.observe()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, name="paddle-tsdb",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- queries -------------------------------------------------------------
    def series_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _match(self, selector: Optional[str]) -> List[str]:
        # caller holds self._lock
        return match_series(self._series.keys(), selector)

    def window_agg(self, selector: str, window_s: float, agg: str,
                   now: Optional[float] = None) -> Dict[str, float]:
        """{series_id: aggregate} over the window for each matching series
        that has points in it — the alert engine's evaluation primitive."""
        out: Dict[str, float] = {}
        with self._lock:
            for sid in self._match(selector):
                v = self._series[sid].window_agg(window_s, agg, now)
                if v is not None:
                    out[sid] = v
        return out

    def query(self, selector: Optional[str] = None,
              window_s: Optional[float] = None,
              max_points: Optional[int] = None,
              now: Optional[float] = None) -> dict:
        """Strict-JSON-able ``/query`` body: matched series with their
        best-tier points for the window."""
        if now is None:
            now = time.time()
        rows = []
        with self._lock:
            for sid in self._match(selector):
                ring = self._series[sid]
                tier, pts = ring.points(window_s, now)
                pts = [[p[0], p[1]] for p in pts]
                if max_points is not None and len(pts) > max_points:
                    pts = pts[-max_points:]
                rows.append({"id": sid, "kind": ring.kind, "tier": tier,
                             "points": pts})
        return {"now": now, "interval_s": self.interval_s,
                "window_s": window_s, "series": rows}

    def jsonable(self, max_points: Optional[int] = None) -> dict:
        """Bounded full dump for the TCPStore fleet plane: the most recent
        ``max_points`` of each tier per series (default
        ``FLAGS_obs_tsdb_publish_points``)."""
        if max_points is None:
            max_points = int(_flag("obs_tsdb_publish_points", 64))
        out: Dict[str, dict] = {}
        with self._lock:
            for sid, ring in self._series.items():
                out[sid] = {
                    "kind": ring.kind,
                    "raw": [list(p) for p in list(ring.raw)[-max_points:]],
                    "coarse": [list(p)
                               for p in list(ring.coarse)[-max_points:]],
                }
        return {"interval_s": self.interval_s, "series": out}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._prev.clear()
            self.samples = 0


# -- module singleton --------------------------------------------------------
_hist: Optional[MetricHistory] = None
_hist_lock = threading.Lock()


def enable(interval_s: Optional[float] = None,
           capacity: Optional[int] = None,
           registry: Optional[Registry] = None,
           start_thread: bool = True) -> MetricHistory:
    """Arm the history plane (idempotent).  Samples the package registry
    unless an explicit one is given; ``start_thread=False`` leaves the
    sampler to be driven manually (tests)."""
    global _hist
    with _hist_lock:
        if _hist is not None:
            return _hist
        if registry is None:
            from . import get_registry

            registry = get_registry()
        _hist = MetricHistory(registry, interval_s=interval_s,
                              capacity=capacity)
        if start_thread:
            _hist.start()
        return _hist


def disable() -> None:
    global _hist
    with _hist_lock:
        h, _hist = _hist, None
    if h is not None:
        h.stop()


def get() -> Optional[MetricHistory]:
    return _hist


def reset() -> None:
    disable()


def query_body(selector: Optional[str], window_s: Optional[float],
               max_points: Optional[int] = None) -> Tuple[int, str, str]:
    """The ``/query`` exporter route body: strict JSON whether or not the
    plane is armed."""
    h = get()
    if h is None:
        doc = {"enabled": False, "series": []}
        return 200, "application/json", json.dumps(doc)
    doc = h.query(selector, window_s, max_points=max_points)
    doc["enabled"] = True
    return 200, "application/json", json.dumps(doc)
