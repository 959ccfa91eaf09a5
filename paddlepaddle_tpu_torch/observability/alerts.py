"""Declarative alert rules over the metric history plane.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
alerts.py``: the same engine and the reference's ten default rules
(:func:`default_rules`) over the reference's metric names, installed by
``observability.enable_history()``, never at import.

The SRE-workbook shape: a rule is an AND of window predicates over
:mod:`tsdb` series — the canonical pair being a *fast* and a *slow* window
on the same burn-rate series (``5m AND 1h``), so a transient spike clears
the fast window before the slow one confirms it, and a slow leak trips the
slow window even when each fast window looks tolerable.  ``for_s`` adds a
hold-down on top: the conditions must hold continuously that long before
the rule transitions pending -> firing.

The engine evaluates on every sampler tick (it registers as a
:class:`~.tsdb.MetricHistory` listener).  Firing is observable everywhere
an operator might already be looking:

* ``paddle_alerts_firing{alert=}`` gauge (1 while firing) and
  ``paddle_alerts_fired_total{alert=}`` counter;
* a ``/healthz`` provider block (page-severity firing => not ok);
* flight-recorder events on every transition, plus exactly ONE automatic
  ``flight.dump("alert-<name>")`` per firing episode with the N slowest
  request journeys attached (joining "alert fired" to "these requests");
* the ``/alerts`` exporter route and ``obsctl alerts`` / ``obsctl top``.

A default ruleset (:func:`default_rules`) covers the failure modes the
serving planes already measure: TTFT/TPOT burn, shed requests, breaker
open, KV page exhaustion, recompile storms and fleet snapshot staleness.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import flight

__all__ = [
    "AlertCondition", "AlertRule", "AlertState", "AlertEngine",
    "default_rules", "install", "uninstall", "get",
]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


class AlertCondition:
    """One window predicate: ``agg(series over window_s) op threshold``.

    A selector matching several label variants holds when ANY variant
    violates (worst-case semantics — one bad replica pages).  A selector
    with no points in the window does not hold: absence of data is absence
    of evidence, never a page.
    """

    __slots__ = ("series", "window_s", "agg", "op", "threshold")

    def __init__(self, series: str, window_s: float, agg: str, op: str,
                 threshold: float):
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}")
        if agg not in ("avg", "min", "max", "sum", "last"):
            raise ValueError(f"unknown agg {agg!r}")
        self.series = series
        self.window_s = float(window_s)
        self.agg = agg
        self.op = op
        self.threshold = float(threshold)

    def evaluate(self, history, now=None):
        """``(holds, worst_value_or_None, series_id_or_None)``."""
        vals = history.window_agg(self.series, self.window_s, self.agg, now)
        worst = None
        for sid, v in vals.items():
            if _OPS[self.op](v, self.threshold):
                if worst is None or _OPS[self.op](v, worst[0]):
                    worst = (v, sid)
        if worst is not None:
            return True, worst[0], worst[1]
        if vals:
            return False, max(vals.values()), None
        return False, None, None

    def jsonable(self) -> dict:
        return {"series": self.series, "window_s": self.window_s,
                "agg": self.agg, "op": self.op, "threshold": self.threshold}

    def __repr__(self):
        return (f"{self.agg}({self.series}[{self.window_s:g}s]) "
                f"{self.op} {self.threshold:g}")


class AlertRule:
    """AND of conditions + hold-down + severity.  ``severity`` is ``page``
    (flips ``/healthz``, triggers the flight dump) or ``warn``."""

    __slots__ = ("name", "conditions", "for_s", "severity", "description")

    def __init__(self, name: str, conditions: Sequence[AlertCondition],
                 for_s: float = 0.0, severity: str = "page",
                 description: str = ""):
        if severity not in ("page", "warn"):
            raise ValueError(f"severity must be page|warn, got {severity!r}")
        if not conditions:
            raise ValueError("a rule needs at least one condition")
        self.name = name
        self.conditions = list(conditions)
        self.for_s = float(for_s)
        self.severity = severity
        self.description = description

    def jsonable(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "for_s": self.for_s, "description": self.description,
                "conditions": [c.jsonable() for c in self.conditions]}


class AlertState:
    """Mutable evaluation state for one rule: ``ok`` -> ``pending`` (all
    conditions hold, hold-down running) -> ``firing``."""

    __slots__ = ("rule", "state", "since", "value", "series_id",
                 "fired_total", "last_dump", "last_change")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = "ok"
        self.since: Optional[float] = None       # start of current hold
        self.value: Optional[float] = None       # worst violating value
        self.series_id: Optional[str] = None
        self.fired_total = 0
        self.last_dump: Optional[str] = None     # dump path of this episode
        self.last_change: Optional[float] = None

    def jsonable(self) -> dict:
        return {
            "name": self.rule.name, "severity": self.rule.severity,
            "state": self.state, "since": self.since, "value": self.value,
            "series": self.series_id, "for_s": self.rule.for_s,
            "fired_total": self.fired_total, "last_change": self.last_change,
            "description": self.rule.description,
            "conditions": [c.jsonable() for c in self.rule.conditions],
        }


def _slowest_journeys(n: int = 3) -> List[dict]:
    """The N slowest completed request journeys, joined through the
    reqtrace exemplar lists (slowest-by-latency trace ids) back to their
    full journey records — what an alert dump attaches so "TTFT burn
    fired" arrives with "and these were the requests"."""
    try:
        from . import reqtrace

        seen: Dict[str, float] = {}
        for ex in (reqtrace.exemplars() or {}).values():
            for row in ex.get("slowest", ()):
                tid = row.get("trace_id")
                if tid is None:
                    continue
                v = float(row.get("value_s") or 0.0)
                if v >= seen.get(tid, -1.0):
                    seen[tid] = v
        out = []
        for tid in sorted(seen, key=seen.get, reverse=True)[:n]:
            j = reqtrace.get(tid)
            if j is not None:
                out.append(j.jsonable())
        return out
    except Exception:
        return []


class AlertEngine:
    """Evaluates rules against a :class:`~.tsdb.MetricHistory` on its
    sampler tick.  Pure with respect to wiring: exporter/health and fleet
    hookup live in ``observability.__init__``."""

    def __init__(self, history, rules: Optional[Sequence[AlertRule]] = None,
                 registry=None, dump_journeys: int = 3):
        if rules is None:
            rules = default_rules()
        self.history = history
        self.states = {r.name: AlertState(r) for r in rules}
        self.dump_journeys = int(dump_journeys)
        self.ticks = 0
        self._lock = threading.Lock()
        if registry is None:
            from . import get_registry

            registry = get_registry()
        self._firing_g = registry.gauge(
            "paddle_alerts_firing",
            "1 while the named alert rule is firing")
        self._fired_c = registry.counter(
            "paddle_alerts_fired_total",
            "alert rule firing transitions (pending -> firing)")
        flight.annotate("alert_slowest_journeys",
                        lambda: _slowest_journeys(self.dump_journeys))

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, history=None, now: Optional[float] = None) -> None:
        """One pass over every rule (the tsdb listener signature)."""
        if now is None:
            now = time.time()
        h = history if history is not None else self.history
        with self._lock:
            for st in self.states.values():
                self._eval_rule(st, h, now)
            self.ticks += 1

    def _eval_rule(self, st: AlertState, h, now: float) -> None:
        holds = True
        worst = None
        for cond in st.rule.conditions:
            ok, val, sid = cond.evaluate(h, now)
            if not ok:
                holds = False
                break
            if worst is None or (val is not None and val > worst[0]):
                worst = (val, sid)
        if holds:
            st.value, st.series_id = worst if worst else (None, None)
            if st.state == "ok":
                st.state = "pending"
                st.since = now
                st.last_change = now
                flight.record("alert", st.rule.name, state="pending",
                              value=st.value, series=st.series_id)
            if st.state == "pending" and now - st.since >= st.rule.for_s:
                self._fire(st, now)
        else:
            if st.state != "ok":
                cleared_from = st.state
                st.state = "ok"
                st.since = None
                st.last_change = now
                self._firing_g.set(0, alert=st.rule.name)
                flight.record("alert", st.rule.name, state="ok",
                              cleared_from=cleared_from)
                st.last_dump = None   # next episode dumps again
            st.value, st.series_id = None, None

    def _fire(self, st: AlertState, now: float) -> None:
        st.state = "firing"
        st.last_change = now
        st.fired_total += 1
        self._firing_g.set(1, alert=st.rule.name)
        self._fired_c.inc(alert=st.rule.name)
        flight.record("alert", st.rule.name, state="firing",
                      severity=st.rule.severity, value=st.value,
                      series=st.series_id)
        if st.rule.severity == "page" and st.last_dump is None:
            # exactly one automatic black-box dump per firing episode,
            # carrying the slowest-journey annotation resolved at dump time
            st.last_dump = flight.dump(f"alert-{st.rule.name}") or "skipped"

    # -- read side -----------------------------------------------------------
    def firing(self, severity: Optional[str] = None) -> List[AlertState]:
        with self._lock:
            return [st for st in self.states.values()
                    if st.state == "firing"
                    and (severity is None or st.rule.severity == severity)]

    def snapshot(self) -> dict:
        with self._lock:
            return {"ticks": self.ticks,
                    "rules": [st.jsonable()
                              for st in sorted(self.states.values(),
                                               key=lambda s: s.rule.name)]}

    def health(self) -> dict:
        """The ``/healthz`` provider block: not-ok while any page-severity
        rule fires."""
        firing = self.firing()
        return {
            "ok": not any(st.rule.severity == "page" for st in firing),
            "firing": [{"name": st.rule.name, "severity": st.rule.severity,
                        "value": st.value, "series": st.series_id,
                        "since": st.since}
                       for st in firing],
            "rules": len(self.states), "ticks": self.ticks,
        }

    def signal(self) -> dict:
        """What the autoscaler consumes instead of re-deriving burn
        thresholds: is a burn rule firing (or any page rule at all)."""
        firing = self.firing()
        burn = [st.rule.name for st in firing
                if "burn" in st.rule.name and st.rule.severity == "page"]
        return {
            "armed": True,
            "burn_firing": burn,
            "page_firing": [st.rule.name for st in firing
                            if st.rule.severity == "page"],
            "warn_firing": [st.rule.name for st in firing
                            if st.rule.severity == "warn"],
        }


def default_rules() -> List[AlertRule]:
    """The shipped ruleset over series the serving planes already emit.
    Burn rules use the fast+slow window pair; thresholds sit at burn==1
    (spending the error budget exactly as it accrues) with the fast window
    catching cliffs and the slow window confirming sustained burn.  Early
    in a process's life both windows clip to the available history, so a
    cold start behaves like a single-window rule until history accrues."""
    from ..core import flags as _flags

    publish = float(_flags.flag_value("obs_publish_interval_s") or 2.0)
    return [
        AlertRule(
            "ttft_burn",
            [AlertCondition("paddle_slo_burn_ttft", 60.0, "avg", ">", 1.0),
             AlertCondition("paddle_slo_burn_ttft", 300.0, "avg", ">", 1.0)],
            for_s=0.0, severity="page",
            description="TTFT SLO error budget burning faster than it "
                        "accrues on both the fast and slow window"),
        AlertRule(
            "tpot_burn",
            [AlertCondition("paddle_slo_burn_tpot", 60.0, "avg", ">", 1.0),
             AlertCondition("paddle_slo_burn_tpot", 300.0, "avg", ">", 1.0)],
            for_s=0.0, severity="page",
            description="TPOT SLO error budget burning faster than it "
                        "accrues on both the fast and slow window"),
        AlertRule(
            "requests_dropped",
            [AlertCondition("paddle_serving_shed_total", 60.0, "max",
                            ">", 0.0)],
            for_s=0.0, severity="page",
            description="requests shed/dropped in the last minute "
                        "(rate of paddle_serving_shed_total > 0)"),
        AlertRule(
            "breaker_open",
            [AlertCondition("paddle_serving_breaker_state", 30.0, "max",
                            ">=", 2.0)],
            for_s=0.0, severity="page",
            description="a serving circuit breaker reached open (state 2)"),
        AlertRule(
            "kv_pages_exhausted",
            [AlertCondition("paddle_serving_kv_pages_free", 60.0, "max",
                            "<=", 0.0)],
            for_s=0.0, severity="warn",
            description="the paged KV pool had zero free pages for a full "
                        "minute — admissions are queuing on preemption"),
        AlertRule(
            "kv_host_tier_full",
            # published by engines with the host prefix tier armed
            # (ROADMAP item 4): sustained near-full occupancy means every
            # further spill discards a cached prefix — the tier has
            # degraded to plain eviction and the budget needs raising
            [AlertCondition("paddle_serving_kv_host_occupancy", 60.0,
                            "avg", ">=", 0.9)],
            for_s=0.0, severity="warn",
            description="the host-RAM prefix tier averaged >= 90% of its "
                        "byte budget over the last minute — spills are "
                        "discarding cached prefixes instead of keeping "
                        "them warm"),
        AlertRule(
            "recompile_storm",
            [AlertCondition("paddle_jit_compiles_total", 60.0, "avg",
                            ">", 0.2)],
            for_s=0.0, severity="warn",
            description="sustained jit recompilation (> 0.2 compiles/s "
                        "averaged over a minute): shape churn is eating "
                        "the device"),
        AlertRule(
            "replica_stalled",
            [AlertCondition("paddle_replica_stalls_total", 60.0, "max",
                            ">", 0.0)],
            for_s=0.0, severity="warn",
            description="a stream-progress watchdog tripped in the last "
                        "minute — a replica connection black-holed or a "
                        "replica stopped producing frames"),
        AlertRule(
            "replica_stalled_sustained",
            [AlertCondition("paddle_replica_stalls_total", 60.0, "avg",
                            ">", 0.02),
             AlertCondition("paddle_replica_stalls_total", 300.0, "avg",
                            ">", 0.005)],
            for_s=0.0, severity="page",
            description="stall-detector trips sustained on both the fast "
                        "and slow window (> ~1/min) — a partial partition "
                        "or a gray-failing replica, not a one-off blip"),
        AlertRule(
            "waste_burn",
            # the goodput plane's sliding-window waste share: sustained
            # over-budget waste on both windows catches hedge storms and
            # spec-rejection storms; a brief hedge burst (the fast window
            # alone) is the feature working as designed, not an alert
            [AlertCondition("paddle_goodput_waste_pct", 60.0, "avg",
                            ">", 50.0),
             AlertCondition("paddle_goodput_waste_pct", 300.0, "avg",
                            ">", 50.0)],
            for_s=0.0, severity="warn",
            description="more than half the decoded tokens are wasted "
                        "(hedge losers / spec rejects / retry discards) "
                        "on both the fast and slow window — the fleet is "
                        "burning device time on work nobody receives"),
        AlertRule(
            "hbm_headroom",
            # published by the memory ledger ONLY on backends that report
            # a device memory limit — on CPU the series never exists and
            # the alert engine's absence-of-data rule keeps this silent
            [AlertCondition("paddle_mem_headroom_ratio", 60.0, "avg",
                            "<", 0.05)],
            for_s=60.0, severity="page",
            description="device memory headroom below 5% for a sustained "
                        "minute — the next admission burst or compile "
                        "workspace spike OOMs the device"),
        AlertRule(
            "fleet_snapshot_stale",
            [AlertCondition("paddle_fleet_snapshot_age_seconds", 60.0,
                            "last", ">", 3.0 * publish)],
            for_s=0.0, severity="warn",
            description="a rank's fleet snapshot is older than 3x the "
                        "publish interval — its merged view is silently "
                        "stale"),
    ]


# -- module singleton --------------------------------------------------------
_engine: Optional[AlertEngine] = None
_engine_lock = threading.Lock()


def install(history=None, rules: Optional[Sequence[AlertRule]] = None,
            registry=None) -> AlertEngine:
    """Create the engine over the armed history plane and subscribe it to
    the sampler tick (idempotent)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            return _engine
        if history is None:
            from . import tsdb

            history = tsdb.get()
            if history is None:
                raise RuntimeError("alerts.install() needs tsdb enabled")
        _engine = AlertEngine(history, rules=rules, registry=registry)
        history.add_listener(_engine.evaluate)
        return _engine


def uninstall() -> None:
    global _engine
    with _engine_lock:
        eng, _engine = _engine, None
    if eng is not None and eng.history is not None:
        eng.history.remove_listener(eng.evaluate)


def get() -> Optional[AlertEngine]:
    return _engine


def alerts_body() -> tuple:
    """The ``/alerts`` exporter route: strict JSON either way."""
    eng = get()
    if eng is None:
        doc = {"enabled": False, "rules": []}
    else:
        doc = eng.snapshot()
        doc["enabled"] = True
    return 200, "application/json", json.dumps(doc)
