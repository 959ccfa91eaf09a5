"""Elastic fleet control plane — SLO-driven autoscaling + zero-downtime
continuous deploy: the loop that closes over the serving signals (health,
SLO burn, alerts) and the router's membership and restart machinery.

The port's own copy of the jax-free ``paddlepaddle_tpu/inference/
fleet.py``, over the port's router, replicas and bundles: a deploy's
candidate is validated by the port's :func:`~.compile_plan.validate_bundle`
(a manifest plus the kernel libraries the plan launches).

Reference surface: the reference framework's fleet executor / PS layer
(``paddle/fluid`` distributed fleet — elastic scaling and deployment as
first-class runtime capability, not an ops afterthought). This form:
a :class:`FleetController` owns a :class:`~.router.ServingRouter` plus a
VERSIONED replica factory and runs two control loops over them.

**Autoscaler** — a daemon loop reads the router's ``health()`` snapshot
(per-replica ``est_wait_s``/``queue_depth``, healthy census, and the
``slo_burn`` block) and:

* scales UP on a sustained violation (SLO burn over budget, or estimated
  wait over bound): a fresh replica is built from the CURRENT version's
  factory, started, PRE-WARMED out of rotation (bring-up skips the
  kernel build when the factory arms it from a serving bundle), and
  only then joins the pick set;
* scales DOWN sustained-idle replicas by deliberate drain (in-flight
  finishes, queued requests fail over; none of it is breaker evidence);
* is guarded against box noise by HYSTERESIS (a violation/idle reading
  must persist ``up_streak``/``down_streak`` consecutive ticks), COOLDOWN
  windows after any scale action, and hard ``min/max_replicas`` bounds —
  one hot probe cannot flap the fleet.

**Deploy pipeline** — :meth:`FleetController.deploy(bundle_path)`:

1. *validate*: the candidate bundle's manifest + payload sha256s are
   pre-flighted stdlib-cheap (:func:`~.compile_plan.validate_bundle`);
   a corrupt artifact raises :class:`~.robustness.DeployError` before any
   replica is touched;
2. *canary*: ONE replica is restarted onto the candidate (out of
   rotation), pre-warmed, health-gated, then probed with real requests;
   the promotion decision is a perf-gate-shaped check over the canary's
   serving SLO numbers (+ the cold-start facts its warmup reports);
3. *rollout*: replica-by-replica through the router's
   :meth:`~.router.ServingRouter.restart_replica` machinery (the
   zero-drop path), each one health-gated and burn-checked before the
   next — replicas the autoscaler adds MID-rollout are picked up too;
4. *rollback*: any health/SLO-burn regression mid-rollout automatically
   restores the PREVIOUS bundle on every updated replica — the rolling
   restart's abort-and-stay-out becomes abort-and-RESTORE: a bad deploy can never
   walk the fleet down, and the fleet ends a failed rollout serving the
   old version everywhere.

Observability: ``paddle_fleet_{replicas_target,replicas,scale_ups,
scale_downs,scaleup_to_healthy_seconds,rollouts,rollbacks}_*`` metrics,
``fleet`` events in the crash flight recorder, ``fleet.scale`` /
``fleet.rollout`` spans in the request-journey plane (reqtrace), and a
``fleet`` block in :meth:`FleetController.health` served as a ``/healthz``
provider (rendered by ``obsctl fleet TARGET``).

Everything here is host-side stdlib — the replicas own the device.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import flags as _flags
from . import compile_plan as _cp
from .robustness import DeployError
from .robustness import safe_inc as _safe_inc
from .robustness import safe_set as _safe_set
from .router import ReplicaClient, ServingRouter
from .serving import _flight_record, slo_summary

__all__ = ["FleetPolicy", "FleetController", "decide",
           "perf_verdict_gate", "DeployError"]


class FleetPolicy:
    """Scaling policy: triggers, hysteresis, cooldowns, bounds. Defaults
    are deliberately conservative — a fleet that scales a beat late beats
    one that flaps (docs/serving.md "Elastic fleet" has the full table).

    * scale UP when, for ``up_streak`` consecutive ticks, SLO burn exceeds
      ``scale_up_burn`` (burn 1.0 = the whole error budget is being spent)
      OR the worst healthy replica's ``est_wait_s`` exceeds
      ``scale_up_est_wait_s``;
    * scale DOWN when, for ``down_streak`` consecutive ticks, every
      healthy replica's ``est_wait_s`` is under ``idle_est_wait_s``, the
      queues are empty, and burn is under ``idle_burn``;
    * any scale action starts a cooldown (``cooldown_up_s`` before the
      next up, ``cooldown_down_s`` before the next down — down is slower
      on purpose: adding capacity you did not need costs dollars, removing
      capacity you did need costs SLO);
    * ``min_replicas``/``max_replicas`` are hard bounds.
    """

    def __init__(self,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 scale_up_est_wait_s: float = 1.0,
                 scale_up_burn: float = 1.0,
                 up_streak: int = 2,
                 idle_est_wait_s: float = 0.05,
                 idle_burn: float = 0.5,
                 down_streak: int = 5,
                 cooldown_up_s: float = 10.0,
                 cooldown_down_s: float = 30.0,
                 interval_s: float = 1.0,
                 rollback_burn: Optional[float] = None,
                 health_timeout_s: float = 60.0,
                 drain_timeout_s: Optional[float] = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas {min_replicas}")
        if up_streak < 1 or down_streak < 1:
            raise ValueError("up_streak/down_streak must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_est_wait_s = float(scale_up_est_wait_s)
        self.scale_up_burn = float(scale_up_burn)
        self.up_streak = int(up_streak)
        self.idle_est_wait_s = float(idle_est_wait_s)
        self.idle_burn = float(idle_burn)
        self.down_streak = int(down_streak)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.interval_s = float(interval_s)
        # mid-rollout regression bar: default = the scale-up bar (burn
        # past it means the candidate is eating the error budget)
        self.rollback_burn = (self.scale_up_burn if rollback_burn is None
                              else float(rollback_burn))
        self.health_timeout_s = float(health_timeout_s)
        self.drain_timeout_s = drain_timeout_s

    def describe(self) -> Dict[str, object]:
        return {k: v for k, v in vars(self).items()}


def decide(policy: FleetPolicy, sig: Dict[str, object],
           state: Dict[str, object], now: float):
    """One autoscaler tick's decision: ``("up"|"down"|None, reason)``.

    Pure over its inputs except the hysteresis counters in ``state``
    (``hot``/``idle`` streaks) which it advances — the caller owns
    ``last_action_t`` (cooldowns) and resets streaks when it actually
    executes an action. Split out of the controller so the policy is unit-
    testable with synthetic signals, no fleet required."""
    est = float(sig.get("est_wait_max") or 0.0)
    burn = sig.get("burn")           # None = SLO targets not armed
    actual = int(sig.get("replicas") or 0)
    depth = int(sig.get("queue_depth") or 0)
    alerts_sig = sig.get("alerts")   # alert engine armed: ONE definition
    #                                  of "burn is violating" — the rule's,
    #                                  with its multi-window + hold-down
    #                                  semantics, not a re-derived threshold

    hot_reason = None
    burn_violating = None            # None = nothing armed says either way
    if alerts_sig is not None:
        firing = list(alerts_sig.get("burn_firing") or ())
        burn_violating = bool(firing)
        if firing:
            hot_reason = f"burn alert firing: {'+'.join(firing)}"
    elif burn is not None:
        burn_violating = burn > policy.scale_up_burn
        if burn_violating:
            hot_reason = (f"slo_burn {burn:.2f} > budget "
                          f"{policy.scale_up_burn:g}")
    if hot_reason is None and est > policy.scale_up_est_wait_s:
        hot_reason = (f"est_wait {est:.2f}s > "
                      f"{policy.scale_up_est_wait_s:g}s")
    idle = (est <= policy.idle_est_wait_s and depth == 0
            and (burn_violating is None or not burn_violating)
            and (alerts_sig is not None
                 or burn is None or burn <= policy.idle_burn))

    if hot_reason:
        state["hot"] = state.get("hot", 0) + 1
        state["idle"] = 0
    elif idle:
        state["idle"] = state.get("idle", 0) + 1
        state["hot"] = 0
    else:
        state["hot"] = state["idle"] = 0

    last = state.get("last_action_t")
    if hot_reason and state["hot"] >= policy.up_streak:
        if actual >= policy.max_replicas:
            return None, f"{hot_reason} but at max_replicas " \
                         f"{policy.max_replicas}"
        if last is not None and now - last < policy.cooldown_up_s:
            return None, f"{hot_reason} but in scale cooldown " \
                         f"({policy.cooldown_up_s - (now - last):.1f}s left)"
        return "up", f"{hot_reason} for {state['hot']} ticks"
    if idle and state["idle"] >= policy.down_streak:
        if actual <= policy.min_replicas:
            return None, "idle but at min_replicas " \
                         f"{policy.min_replicas}"
        if last is not None and now - last < policy.cooldown_down_s:
            return None, "idle but in scale cooldown " \
                         f"({policy.cooldown_down_s - (now - last):.1f}s left)"
        return "down", (f"idle (est_wait {est:.3f}s, queue 0) for "
                        f"{state['idle']} ticks")
    return None, (hot_reason and f"{hot_reason} (streak {state['hot']}/"
                  f"{policy.up_streak})") or \
        (idle and f"idle (streak {state['idle']}/{policy.down_streak})") \
        or "steady"


def perf_verdict_gate(verdict) -> Callable[[Dict], List[str]]:
    """Build a deploy ``gate=`` callable from a ``tools/perf_gate.py
    --json`` verdict document — a parsed dict, a JSON string, or a path to
    the file ``--json`` wrote. The gate vetoes promotion with one reason
    per non-ok field row (regressions and missing metrics), so CI can run
    the bench against the candidate, gate it, and hand the machine verdict
    straight to :meth:`FleetController.deploy` without parsing the human
    report."""
    import json as _json

    if isinstance(verdict, (str, os.PathLike)):
        s = str(verdict)
        if s.lstrip().startswith("{"):
            verdict = _json.loads(s)
        else:
            with open(s) as f:
                verdict = _json.load(f)
    if not isinstance(verdict, dict):
        raise TypeError(f"verdict must be dict/JSON/path, got "
                        f"{type(verdict).__name__}")
    doc = dict(verdict)

    def gate(_canary_metrics: Dict[str, object]) -> List[str]:
        reasons = []
        for row in doc.get("fields", ()):
            if row.get("verdict") in ("regression", "missing"):
                reasons.append(
                    f"perf_gate {row.get('verdict')}: {row.get('metric')} "
                    f"baseline={row.get('baseline')} "
                    f"candidate={row.get('candidate')} "
                    f"({row.get('direction', '?')} is better)")
        if not doc.get("ok", not reasons):
            reasons = reasons or ["perf_gate verdict not ok"]
        return reasons

    return gate


class FleetController:
    """Owns a :class:`~.router.ServingRouter` + a versioned replica
    factory; closes the elastic control loop over them.

    ``factory`` is ``Callable[[Optional[str]], ServingEngine]`` — called
    with the fleet's current VERSION (a serving-bundle path, or ``None``
    before any deploy) every time a replica engine is (re)built. A
    production factory passes the version through as
    ``ServingEngine(model, bundle=version)`` so replicas arm from the
    artifact; a test factory may key anything off the label.

    The controller itself serves the engine surface through its router
    (``submit``/``generate``/``health``/``drain``), so callers that
    fronted a :class:`~.router.ServingRouter` front a
    :class:`FleetController` unchanged.
    """

    def __init__(self, factory: Callable[[Optional[str]], object],
                 initial_replicas: int = 2,
                 policy: Optional[FleetPolicy] = None,
                 version: Optional[str] = None,
                 name_prefix: str = "r",
                 **router_kw):
        self.policy = policy or FleetPolicy()
        if not (self.policy.min_replicas <= initial_replicas
                <= self.policy.max_replicas):
            raise ValueError(
                f"initial_replicas {initial_replicas} outside policy "
                f"bounds [{self.policy.min_replicas}, "
                f"{self.policy.max_replicas}]")
        self.factory = factory
        self.version = version          # the bundle every replica serves
        self.previous_version: Optional[str] = None
        self.name_prefix = str(name_prefix)
        self._ids = itertools.count(0)
        self._versions: Dict[str, Optional[str]] = {}
        clients = [self._new_client(version)
                   for _ in range(int(initial_replicas))]
        router_kw.setdefault("drain_timeout_s", self.policy.drain_timeout_s)
        self.router = ServingRouter(clients, **router_kw)
        self.target = int(initial_replicas)
        # one lock serializes every replica-set mutation (scale up/down,
        # rollout/rollback steps) — reads stay lock-free on the router's
        # copy-on-write snapshots, so the autoscaler and a deploy can
        # interleave without either seeing a half-mutated fleet
        self._scale_lock = threading.RLock()
        self._deploy_lock = threading.Lock()
        self._state = {"hot": 0, "idle": 0, "last_action_t": None}
        self.last_decision: Dict[str, object] = {
            "action": None, "reason": "never evaluated", "t_mono": None,
            "wall": None}
        self.stats = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                      "scale_up_failures": 0, "rollouts": 0,
                      "rollbacks": 0}
        self.rollout: Dict[str, object] = {
            "state": "idle", "version": None, "previous": None,
            "replica": None, "updated": []}
        self.last_scaleup_to_healthy_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._health_reg_name: Optional[str] = None

    # -- plumbing ------------------------------------------------------------
    def _engine_factory(self, version: Optional[str]):
        factory = self.factory
        fn = lambda: factory(version)  # noqa: E731
        # the version rides the closure so a process-backed client's
        # restart(factory=...) can respawn onto the new bundle path
        fn.version = version
        return fn

    def _new_client(self, version: Optional[str]) -> ReplicaClient:
        name = f"{self.name_prefix}{next(self._ids)}"
        self._versions[name] = version
        if getattr(self.factory, "makes_clients", False):
            # a ProcessReplicaFactory builds the whole client (supervisor
            # + RemoteReplicaClient over a fresh OS process), not an
            # engine — the controller manages processes, same surface
            return self.factory(version, name=name)
        return ReplicaClient(self._engine_factory(version), name=name)

    def _journey(self, tag: str):
        try:
            from ..observability import reqtrace as _rt

            if _rt.enabled():
                return _rt.mint(tag)
        except Exception:
            pass
        return None

    def _finish_journey(self, j, outcome: str) -> None:
        if j is None:
            return
        try:
            from ..observability import reqtrace as _rt

            _rt.finish(j, outcome)
        except Exception:
            pass

    def _gauge_census(self) -> None:
        _safe_set("paddle_fleet_replicas_target",
                  "replica count the fleet controller is steering toward",
                  self.target)
        _safe_set("paddle_fleet_replicas",
                  "replicas currently in the fleet",
                  len(self.router._replicas))

    # -- signal + decision ---------------------------------------------------
    def read_signal(self) -> Dict[str, object]:
        """The autoscaler's input, distilled from ``router.health()``:
        worst healthy est-wait, fleet queue depth, healthy census, and
        the worst armed SLO burn (None when no target is armed or nothing
        is measurable yet — a fleet with no SLO flags scales on est-wait
        alone, it does not scale on fake zeros)."""
        h = self.router.health()
        reps = h.get("replicas", {})
        est = [float(r.get("est_wait_s") or 0.0)
               for r in reps.values() if r.get("ok")]
        depth = sum(int(r.get("queue_depth") or 0)
                    for r in reps.values() if r.get("ok"))
        burn = None
        b = h.get("slo_burn") or {}
        if b.get("enabled"):
            for key in ("ttft", "tpot"):
                kb = b.get(key) or {}
                if kb.get("enabled") and kb.get("burn") is not None:
                    v = float(kb["burn"])
                    burn = v if burn is None else max(burn, v)
        sig = {"replicas": len(reps),
               "healthy": int(h.get("router", {}).get("healthy", 0)),
               "est_wait_max": max(est) if est else 0.0,
               "queue_depth": depth,
               "burn": burn,
               "ok": bool(h.get("ok"))}
        # when the alert engine is installed, its AlertState is the single
        # definition of "the burn is violating" (multi-window + hold-down),
        # and decide() defers to it instead of re-deriving a threshold
        try:
            from ..observability import alerts as _alerts

            eng = _alerts.get()
        except Exception:
            eng = None
        if eng is not None:
            sig["alerts"] = eng.signal()
        return sig

    def _tick(self) -> Dict[str, object]:
        """One autoscaler evaluation (the loop calls this every
        ``policy.interval_s``; tests call it directly). Reads the signal,
        decides, executes, records the decision for ``health()``."""
        self.stats["ticks"] += 1
        sig = self.read_signal()
        now = time.monotonic()
        action, reason = decide(self.policy, sig, self._state, now)
        self.last_decision = {"action": action, "reason": reason,
                              "t_mono": now, "wall": time.time()}
        if action == "up":
            self.scale_up(reason=reason)
        elif action == "down":
            self.scale_down(reason=reason)
        self._gauge_census()
        return {"action": action, "reason": reason, "signal": sig}

    # -- scaling -------------------------------------------------------------
    def scale_up(self, n: int = 1, reason: str = "manual") -> List[str]:
        """Add up to ``n`` replicas (bounded by ``max_replicas``): build
        from the current version's factory, start, PRE-WARM out of
        rotation, join the pick set, then wait (bounded) for the health
        probe — ``scaleup_to_healthy_s`` is the wall from decision to
        in-rotation-and-healthy, the number the bundle-armed bring-up
        exists to keep in seconds. A replica that never turns healthy is
        removed again and counted as a failure, not left as a zombie."""
        added: List[str] = []
        with self._scale_lock:
            for _ in range(int(n)):
                if len(self.router._replicas) >= self.policy.max_replicas:
                    break
                t0 = time.monotonic()
                self.target = len(self.router._replicas) + 1
                self._gauge_census()
                client = self._new_client(self.version)
                j = self._journey(f"fleet-scale-{client.name}")
                try:
                    client.start()
                    try:
                        client.warmup()   # compiles land HERE, before the
                        #   replica can be picked — not on live traffic
                    except Exception as e:
                        sys.stderr.write(
                            f"[fleet] replica {client.name} pre-warm "
                            f"failed ({type(e).__name__}: {e})\n")
                    self.router.add_replica(client)
                except Exception as e:
                    self.stats["scale_up_failures"] += 1
                    self._versions.pop(client.name, None)
                    # a FAILED attempt arms the cooldown too: a
                    # persistently failing factory must back off, not
                    # rebuild/tear down an engine every tick
                    self._state["hot"] = 0
                    self._state["last_action_t"] = time.monotonic()
                    sys.stderr.write(
                        f"[fleet] scale-up replica {client.name} failed to "
                        f"start ({type(e).__name__}: {e})\n")
                    if j is not None:
                        j.event("fleet.scale", replica="fleet",
                                action="up", target=client.name,
                                reason=reason, ok=False)
                    self._finish_journey(j, "error")
                    break
                deadline = time.monotonic() + self.policy.health_timeout_s
                ok = False
                while time.monotonic() < deadline:
                    try:
                        ok = bool(client.health().get("ok", False))
                    except Exception:
                        ok = False
                    if ok:
                        break
                    time.sleep(0.02)
                wall = round(time.monotonic() - t0, 3)
                if not ok:
                    self.stats["scale_up_failures"] += 1
                    self._state["hot"] = 0
                    self._state["last_action_t"] = time.monotonic()
                    try:
                        self.router.remove_replica(
                            client.name, stop=True, reason="scaleup_failed")
                    except Exception:
                        pass
                    self._versions.pop(client.name, None)
                    sys.stderr.write(
                        f"[fleet] scale-up replica {client.name} never "
                        f"turned healthy within "
                        f"{self.policy.health_timeout_s:g}s — removed\n")
                    if j is not None:
                        j.event("fleet.scale", replica="fleet", action="up",
                                target=client.name, reason=reason, ok=False,
                                wall_s=wall)
                    self._finish_journey(j, "error")
                    break
                self.last_scaleup_to_healthy_s = wall
                self.stats["scale_ups"] += 1
                self._state["hot"] = self._state["idle"] = 0
                self._state["last_action_t"] = time.monotonic()
                added.append(client.name)
                _safe_inc("paddle_fleet_scale_ups_total",
                          "replicas added by the fleet controller",
                          replica=client.name)
                _safe_set("paddle_fleet_scaleup_to_healthy_seconds",
                          "wall seconds from scale-up decision to the new "
                          "replica healthy and in rotation", wall)
                _flight_record("fleet", client.name, event="scale_up",
                               reason=reason, wall_s=wall,
                               replicas=len(self.router._replicas))
                sys.stderr.write(
                    f"[fleet] scaled UP: +{client.name} in {wall:.2f}s "
                    f"({reason}) — {len(self.router._replicas)} replicas\n")
                if j is not None:
                    j.event("fleet.scale", replica="fleet", action="up",
                            target=client.name, reason=reason, ok=True,
                            wall_s=wall)
                self._finish_journey(j, "ok")
            self.target = len(self.router._replicas)
            self._gauge_census()
        return added

    def scale_down(self, n: int = 1, reason: str = "manual") -> List[str]:
        """Remove up to ``n`` replicas (bounded by ``min_replicas``) by
        DELIBERATE drain: least-loaded in-rotation replica leaves the
        pick set, finishes its in-flight work (queued requests fail over),
        its engine stops (unregistering its ``/healthz`` provider), and
        the router drops its breaker/prober state with it."""
        removed: List[str] = []
        with self._scale_lock:
            for _ in range(int(n)):
                if len(self.router._replicas) <= self.policy.min_replicas:
                    break
                cands = [r for r in self.router._replicas if r.in_rotation]
                # min_replicas bounds SERVING capacity, not fleet census:
                # during a deploy the canary is deliberately out of
                # rotation, and an idle-streak scale-down must not remove
                # the replica(s) actually carrying the traffic
                if len(cands) - 1 < self.policy.min_replicas:
                    break
                rep = min(cands, key=lambda r: (
                    r.inflight,
                    int((r.snapshot or {}).get("queue_depth") or 0),
                    r.name))
                j = self._journey(f"fleet-scale-{rep.name}")
                res = self.router.remove_replica(
                    rep.name, drain_timeout=self.policy.drain_timeout_s,
                    stop=True, reason="scale_down")
                self._versions.pop(rep.name, None)
                self.stats["scale_downs"] += 1
                self._state["hot"] = self._state["idle"] = 0
                self._state["last_action_t"] = time.monotonic()
                removed.append(rep.name)
                _safe_inc("paddle_fleet_scale_downs_total",
                          "replicas removed by the fleet controller",
                          replica=rep.name)
                _flight_record("fleet", rep.name, event="scale_down",
                               reason=reason, clean=res.get("clean"),
                               replicas=len(self.router._replicas))
                sys.stderr.write(
                    f"[fleet] scaled DOWN: -{rep.name} ({reason}) — "
                    f"{len(self.router._replicas)} replicas\n")
                if j is not None:
                    j.event("fleet.scale", replica="fleet", action="down",
                            target=rep.name, reason=reason,
                            ok=bool(res.get("clean", True)))
                self._finish_journey(j, "ok")
            self.target = len(self.router._replicas)
            self._gauge_census()
        return removed

    # -- deploy pipeline -----------------------------------------------------
    def _update_replica(self, rep, version: Optional[str],
                        readmit: bool = True) -> Dict[str, object]:
        """Move one replica to ``version`` through the router's zero-drop
        restart cycle. Under the scale lock so a concurrent scale-down
        cannot remove the replica mid-update."""
        with self._scale_lock:
            if all(r is not rep for r in self.router._replicas):
                # scaled down between selection and update: nothing to do
                return {"replica": rep.name, "ok": True, "skipped": True}
            info = self.router.restart_replica(
                rep, drain_timeout=self.policy.drain_timeout_s,
                health_timeout=self.policy.health_timeout_s,
                warmup=True, factory=self._engine_factory(version),
                readmit=readmit)
            self._versions[rep.name] = version
            return info

    def _canary_probe(self, rep, n: int, prompt, new_tokens: int,
                      timeout: float) -> Dict[str, object]:
        """Promotion evidence from the (out-of-rotation) canary: submit
        ``n`` real requests straight at its client, count completions,
        measure the SLO numbers, and read its post-probe health + the
        cold-start facts its warmup left behind."""
        if prompt is None:
            prompt = np.zeros((4,), np.int32)
        futs, errors = [], []
        for _ in range(int(n)):
            try:
                futs.append(rep.client.submit(
                    prompt, max_new_tokens=int(new_tokens)))
            except Exception as e:  # noqa: BLE001 — the gate's evidence
                errors.append(f"{type(e).__name__}: {e}")
        completed = 0
        for f in futs:
            try:
                f.result(timeout)
                completed += 1
            except Exception as e:  # noqa: BLE001
                errors.append(f"{type(e).__name__}: {e}")
        try:
            snap = rep.client.health()
            health_ok = bool(snap.get("ok", False))
            compile_block = snap.get("compile") or {}
        except Exception as e:
            health_ok, compile_block = False, {}
            errors.append(f"{type(e).__name__}: {e}")
        metrics = {"submitted": int(n), "completed": completed,
                   "failed": int(n) - completed,
                   "errors": errors[:3], "health_ok": health_ok,
                   # cold-start fields (perf_gate's coldstart.* shape):
                   # a candidate whose warmup left the serve window
                   # compiling would regress every restart it ships to
                   "warmup": compile_block.get("warmup"),
                   "bundle": compile_block.get("bundle")}
        metrics.update(slo_summary(futs))
        return metrics

    def _default_gate(self, metrics: Dict[str, object]) -> List[str]:
        """Promotion decision over the canary metrics: every probe request
        completed, the replica is healthy, and — when SLO targets are
        armed (``FLAGS_slo_ttft_ms``) — the canary's TTFT p99 is inside
        the target. Returns the list of violated reasons (empty = promote);
        a custom ``gate=`` callable replaces this wholesale (e.g. a
        tools/perf_gate comparison against a recorded baseline)."""
        reasons = []
        if metrics["completed"] < metrics["submitted"]:
            reasons.append(
                f"{metrics['failed']} of {metrics['submitted']} canary "
                f"requests failed ({'; '.join(metrics['errors'])})")
        if not metrics["health_ok"]:
            reasons.append("canary replica health not ok after probe")
        try:
            slo_ttft = float(_flags.flag_value("slo_ttft_ms"))
        except Exception:
            slo_ttft = 0.0
        p99 = metrics.get("ttft_p99_ms")
        if slo_ttft > 0 and p99 is not None and p99 > slo_ttft:
            reasons.append(f"canary ttft_p99 {p99}ms > SLO target "
                           f"{slo_ttft:g}ms")
        bundle = metrics.get("bundle")
        if isinstance(bundle, dict) and bundle.get("path") \
                and not bundle.get("loaded"):
            reasons.append(
                f"candidate bundle fell back to lazy builds on the canary "
                f"({bundle.get('error', 'unknown cause')})")
        return reasons

    def _rollback(self, prev: Optional[str], reasons: List[str],
                  stage: str, j=None) -> None:
        """Restore ``prev`` on every replica not serving it. A replica
        that fails even the rollback's health gate is left out of
        rotation (the rolling-restart abort rule) — the rest of the fleet
        keeps serving the previous version."""
        self.rollout = dict(self.rollout, state="rolling_back",
                            reasons=list(reasons))
        sys.stderr.write(
            f"[fleet] deploy ROLLBACK ({stage}): {'; '.join(reasons)}\n")
        for rep in list(self.router._replicas):
            if self._versions.get(rep.name) == prev:
                continue
            info = self._update_replica(rep, prev, readmit=True)
            if j is not None:
                j.event("fleet.rollout", replica="fleet", phase="rollback",
                        target=rep.name, ok=bool(info.get("ok")))
            if not info.get("ok"):
                sys.stderr.write(
                    f"[fleet] rollback: replica {rep.name} failed its "
                    "health gate on the PREVIOUS version — left out of "
                    "rotation\n")
        self.version = prev
        self.stats["rollbacks"] += 1
        self.rollout = {"state": "rolled_back", "version": self.version,
                        "previous": self.previous_version,
                        "replica": None,
                        "updated": [], "reasons": list(reasons)}
        _safe_inc("paddle_fleet_rollbacks_total",
                  "deploys rolled back to the previous bundle", stage=stage)
        _safe_inc("paddle_fleet_rollouts_total",
                  "deploy rollouts finished, by outcome",
                  outcome="rolled_back")
        _flight_record("fleet", "deploy", event="rollback", stage=stage,
                       reasons="; ".join(reasons)[:200])

    def deploy(self, bundle_path: str,
               gate: Optional[Callable[[Dict], List[str]]] = None,
               canary_requests: int = 4,
               canary_prompt=None,
               canary_new_tokens: int = 4,
               canary_timeout: float = 120.0,
               validate: bool = True) -> Dict[str, object]:
        """Zero-downtime continuous deploy of ``bundle_path`` (see module
        docstring for the state machine). Raises
        :class:`~.robustness.DeployError` only when the deploy cannot
        START (validation failure, concurrent deploy); a candidate that
        fails its canary gate or regresses mid-rollout is an EXPECTED
        outcome — the fleet rolls back automatically and the returned
        result carries ``ok=False`` plus the stage and reasons."""
        if not self._deploy_lock.acquire(blocking=False):
            raise DeployError("a deploy is already in flight", stage="start")
        try:
            manifest = None
            if validate:
                try:
                    manifest = _cp.validate_bundle(bundle_path)
                except Exception as e:
                    raise DeployError(
                        f"candidate bundle {bundle_path} failed validation "
                        f"({type(e).__name__}: {e})", stage="validate",
                        reasons=[str(e)]) from e
            prev = self.version
            target = str(bundle_path)
            # the mid-rollout regression bar INHERITS any burn already in
            # the sliding window: a fleet that was burning before the
            # deploy (a traffic spike still inside FLAGS_slo_burn_window_s)
            # must not have that burn attributed to the candidate — only
            # burn the rollout PUSHES PAST this bar triggers rollback
            burn_bar = max(self.policy.rollback_burn,
                           float(self.read_signal()["burn"] or 0.0))
            result: Dict[str, object] = {
                "ok": False, "stage": "canary", "candidate": target,
                "previous": prev, "version": prev, "reasons": [],
                "replicas": [],
                "manifest_version": (manifest or {}).get("version")}
            j = self._journey("fleet-rollout")
            self.rollout = {"state": "canary", "version": target,
                            "previous": prev, "replica": None,
                            "updated": [],
                            "manifest_version": result["manifest_version"]}
            _flight_record("fleet", "deploy", event="begin",
                           candidate=target,
                           version=str(result["manifest_version"]))

            # -- canary: one replica onto the candidate, OUT of rotation --
            reps = [r for r in self.router._replicas if r.in_rotation] \
                or list(self.router._replicas)
            canary = reps[0]
            self.rollout["replica"] = canary.name
            if j is not None:
                j.event("fleet.rollout", replica="fleet", phase="canary",
                        target=canary.name, candidate=target)
            info = self._update_replica(canary, target, readmit=False)
            result["replicas"].append(info)
            if not info.get("ok"):
                result["reasons"] = [
                    f"canary {canary.name} never turned healthy on the "
                    f"candidate (within {self.policy.health_timeout_s:g}s)"]
                self._rollback(prev, result["reasons"], "canary", j)
                self._finish_journey(j, "rejected")
                return dict(result, version=self.version)
            metrics = self._canary_probe(
                canary, canary_requests, canary_prompt, canary_new_tokens,
                canary_timeout)
            result["canary"] = metrics
            reasons = (gate or self._default_gate)(metrics)
            if reasons:
                result["reasons"] = list(reasons)
                self._rollback(prev, result["reasons"], "canary", j)
                self._finish_journey(j, "rejected")
                return dict(result, version=self.version)
            with self._scale_lock:
                # promotion: the canary takes traffic on the new version
                canary.breaker.reset()
                canary.in_rotation = True

            # -- rollout: walk every stale replica (incl. any the
            #    autoscaler adds mid-rollout at the previous version) ----
            self.rollout = dict(self.rollout, state="rolling")
            result["stage"] = "rollout"
            while True:
                # stale check AND promotion share the scale lock: a
                # concurrent scale_up holds it while it builds/joins a
                # replica at self.version, so either its old-version
                # replica is visible to this check (and gets updated) or
                # it starts after the promotion below and builds at the
                # NEW version — never a mixed-version fleet
                with self._scale_lock:
                    stale = [r for r in self.router._replicas
                             if self._versions.get(r.name) != target]
                    if not stale:
                        self.previous_version = prev
                        self.version = target
                        break
                rep = stale[0]
                self.rollout["replica"] = rep.name
                if j is not None:
                    j.event("fleet.rollout", replica="fleet",
                            phase="replica", target=rep.name)
                info = self._update_replica(rep, target, readmit=True)
                result["replicas"].append(info)
                if not info.get("ok"):
                    result["reasons"] = [
                        f"replica {rep.name} failed its health gate on "
                        "the candidate mid-rollout"]
                    self._rollback(prev, result["reasons"], "rollout", j)
                    self._finish_journey(j, "rejected")
                    return dict(result, version=self.version)
                burn = self.read_signal()["burn"]
                if burn is not None and burn > burn_bar:
                    result["reasons"] = [
                        f"slo_burn {burn:.2f} > rollback bar "
                        f"{burn_bar:g} after updating "
                        f"{rep.name}"]
                    self._rollback(prev, result["reasons"], "rollout", j)
                    self._finish_journey(j, "rejected")
                    return dict(result, version=self.version)
                self.rollout["updated"] = \
                    list(self.rollout["updated"]) + [rep.name]

            # -- promoted (version flipped under the lock above) ---------
            self.stats["rollouts"] += 1
            self.rollout = {"state": "done", "version": target,
                            "previous": prev, "replica": None,
                            "updated": [r.name
                                        for r in self.router._replicas],
                            "manifest_version": result["manifest_version"]}
            _safe_inc("paddle_fleet_rollouts_total",
                      "deploy rollouts finished, by outcome", outcome="ok")
            _flight_record("fleet", "deploy", event="done", candidate=target)
            sys.stderr.write(
                f"[fleet] deploy PROMOTED: {target} on "
                f"{len(self.router._replicas)} replicas\n")
            if j is not None:
                j.event("fleet.rollout", replica="fleet", phase="done",
                        candidate=target)
            self._finish_journey(j, "ok")
            return dict(result, ok=True, stage="done", version=target)
        finally:
            self._deploy_lock.release()

    # -- engine surface ------------------------------------------------------
    def submit(self, prompt_ids, **kw):
        return self.router.submit(prompt_ids, **kw)

    def generate(self, prompt_ids, timeout: float = 300.0, **kw):
        return self.router.generate(prompt_ids, timeout=timeout, **kw)

    def drain(self, timeout: Optional[float] = None) -> Dict[str, object]:
        return self.router.drain(timeout)

    def health(self) -> Dict[str, object]:
        """The router's fleet snapshot plus the ``fleet`` control-plane
        block (replica census vs target, last scale decision, rollout
        state/version, burn readings) — what ``obsctl fleet`` renders."""
        h = self.router.health()
        now = time.monotonic()
        last = dict(self.last_decision)
        t = last.pop("t_mono", None)
        last["age_s"] = None if t is None else round(now - t, 3)
        h["fleet"] = {
            "replicas_target": self.target,
            "replicas": len(self.router._replicas),
            "healthy": h.get("router", {}).get("healthy", 0),
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "version": self.version,
            "previous_version": self.previous_version,
            "versions": dict(self._versions),
            "autoscaler": {
                "running": (self._thread is not None
                            and self._thread.is_alive()),
                "interval_s": self.policy.interval_s,
                "streak": {"hot": self._state["hot"],
                           "idle": self._state["idle"]},
                "last_decision": last,
            },
            "rollout": dict(self.rollout),
            "slo_burn": h.get("slo_burn"),
            "stats": dict(
                self.stats,
                scaleup_to_healthy_s=self.last_scaleup_to_healthy_s),
        }
        return h

    # -- lifecycle -----------------------------------------------------------
    def start(self, autoscaler: bool = True) -> "FleetController":
        """Start the router (+ its prober) and, unless ``autoscaler=
        False`` (tests drive :meth:`_tick` directly), the autoscaler
        loop. Registers the ``fleet`` health provider when an exporter is
        live."""
        self.router.start()
        self._gauge_census()
        if autoscaler and (self._thread is None
                           or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fleet-autoscaler")
            self._thread.start()
        try:
            from ..observability import exporter as _exporter

            served = _exporter.get()
            if served is not None and self._health_reg_name is None:
                self._health_reg_name = served.register_health(
                    "fleet", self.health, unique=True)
        except Exception:
            pass
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self._tick()
            except Exception as e:  # the loop must survive a bad tick
                sys.stderr.write(
                    f"[fleet] autoscaler tick failed "
                    f"({type(e).__name__}: {e})\n")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        try:
            from ..observability import exporter as _exporter

            served = _exporter.get()
            if served is not None and self._health_reg_name is not None:
                served.unregister_health(self._health_reg_name,
                                         fn=self.health)
                self._health_reg_name = None
        except Exception:
            pass
        self.router.stop()

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False
