"""Rank-0 fleet aggregation: one merged view of a whole launched job
(counterpart of ``paddlepaddle_tpu/observability/aggregate.py`` :1-535).

Reference surface: the reference fleet stack aggregates per-worker monitor
stats and multi-worker profiler timelines at the controller
(fleet/monitor + profiler merge tooling); trace correlation needs a shared
clock. The job's TCPStore (:mod:`..distributed.store`, the one the
launcher hosts) carries the telemetry too, with no new transport:

* every worker runs a :class:`FleetPublisher` (daemon thread) that
  periodically writes its store keys ``obs/clock/rank{r}`` (a
  ``(wall, perf_counter)`` anchor pair), ``obs/metrics/rank{r}`` (the
  Prometheus text of its registry), ``obs/trace/rank{r}`` (its
  chrome-trace ring buffer, when tracing), ``obs/tsdb/rank{r}`` (a bounded
  dump of its metric-history rings, when :mod:`~.tsdb` is armed) and
  ``obs/profile/rank{r}`` (the sampling profiler's hot stacks, when it
  runs), plus a final publish at interpreter exit so a cleanly-exiting
  worker's last snapshot survives it;
* rank 0 (:func:`install_fleet_routes`) swaps its exporter's ``/metrics``
  for :func:`merged_fleet_metrics` (every sample from every rank,
  re-labelled ``rank="r"`` through the strict exposition parser) and adds
  ``/fleet/trace`` (:func:`collect_fleet_trace`: the ranks' chrome traces
  merged into ONE Perfetto file, one ``pid`` per rank), ``/fleet/ranks``
  (who has published, how stale), ``/fleet/query``
  (:func:`collect_fleet_tsdb`: every rank's metric history, keyed by rank)
  and ``/fleet/profile``.

Clock correlation: each rank's recorder timestamps are ``perf_counter``
microseconds with a process-private epoch. The published ``(wall, perf)``
anchor lets the merger shift each rank onto the lowest rank's timeline
(wall clocks are NTP-disciplined across hosts, and one host's processes
share one clock; the residual error is the anchors' sampling error).
Estimation and transport both ride the store: no direct worker-to-worker
connections.
"""

from __future__ import annotations

import atexit
import json
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from ..core import flags as _flags
from .metrics import (
    Registry,
    _esc,
    format_value,
    parse_prometheus_text,
)

__all__ = [
    "FleetPublisher", "merge_prometheus_texts", "merge_chrome_traces",
    "collect_fleet_metrics", "merged_fleet_metrics", "collect_fleet_trace",
    "collect_fleet_tsdb", "fleet_status", "install_fleet_routes",
    "metrics_key", "clock_key", "trace_key", "tsdb_key",
]


def metrics_key(rank: int) -> str:
    return f"obs/metrics/rank{rank}"


def clock_key(rank: int) -> str:
    return f"obs/clock/rank{rank}"


def trace_key(rank: int) -> str:
    return f"obs/trace/rank{rank}"


def tsdb_key(rank: int) -> str:
    return f"obs/tsdb/rank{rank}"


def prof_key(rank: int) -> str:
    return f"obs/profile/rank{rank}"


def _clock_sample() -> dict:
    return {"wall": time.time(), "perf": time.perf_counter()}


class FleetPublisher:
    """Periodic snapshot publication from one worker into the store.

    ``text_fn``/``trace_fn`` are injectable for tests (and for embedding a
    foreign registry); the defaults read this process's observability
    state. Publishing never raises into the training loop — a dead store
    is logged once and retried next interval."""

    def __init__(self, store, rank: int, interval_s: Optional[float] = None,
                 text_fn=None, trace_fn=None, tsdb_fn=None):
        self.store = store
        self.rank = int(rank)
        self.interval_s = float(
            interval_s if interval_s is not None
            else _flags.flag_value("obs_publish_interval_s"))
        self._text_fn = text_fn
        self._trace_fn = trace_fn
        self._tsdb_fn = tsdb_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = False
        self._last_trace_sig = None  # skip unchanged-trace republication

    # -- one publication -----------------------------------------------------
    def publish(self) -> None:
        clock = _clock_sample()
        self.store.set(clock_key(self.rank), json.dumps(clock))
        if self._text_fn is not None:
            text = self._text_fn()
        else:
            from . import to_prometheus_text

            text = to_prometheus_text()
        self.store.set(metrics_key(self.rank), json.dumps(
            {"wall": clock["wall"], "rank": self.rank, "prom": text}))
        doc = None
        if self._trace_fn is not None:
            doc = self._trace_fn()
        else:
            # gate on the RUNTIME tracing state (enable(trace=True) and the
            # env flag both set it), not the flag alone — and skip the
            # re-serialize + multi-MB store.set entirely when the ring has
            # not changed since the last publish (each store request holds
            # the client's wire mutex, stalling concurrent collective ops)
            from . import _recorder_if_tracing

            rec = _recorder_if_tracing()
            if rec is not None:
                sig = rec.signature()
                if sig != self._last_trace_sig:
                    self._last_trace_sig = sig
                    doc = rec.to_chrome_trace()
        if doc is not None:
            self.store.set(trace_key(self.rank), json.dumps(
                {"wall": clock["wall"], "trace": doc}))
        hist = None
        if self._tsdb_fn is not None:
            hist = self._tsdb_fn()
        else:
            # publish only when the history plane is armed: the key's
            # absence tells the rank-0 merge "this rank keeps no history",
            # which is different from "stale"
            from . import tsdb as _tsdb

            h = _tsdb.get()
            if h is not None:
                hist = h.jsonable()
        if hist is not None:
            self.store.set(tsdb_key(self.rank), json.dumps(
                {"wall": clock["wall"], "rank": self.rank, "tsdb": hist}))
        # sampling-profiler hot stacks: published only when the profiler
        # is armed — the key's absence tells the rank-0 merge "this rank
        # does not profile", not "stale"
        from . import profiler as _profiler

        prof = _profiler.get()
        if prof is not None:
            self.store.set(prof_key(self.rank), json.dumps(
                {"wall": clock["wall"], "rank": self.rank,
                 "profile": prof.jsonable(seconds=None)}))

    def _publish_safe(self) -> None:
        try:
            self.publish()
            self._warned = False
        except Exception as e:
            if not self._warned:  # say it once, not every interval
                self._warned = True
                sys.stderr.write(
                    f"[obs] fleet publish failed (rank {self.rank}): "
                    f"{e!r}; retrying each interval\n")

    def _loop(self) -> None:
        self._publish_safe()  # first snapshot immediately, not after a wait
        while not self._stop.wait(self.interval_s):
            self._publish_safe()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetPublisher":
        if self._thread is None:
            self._stop.clear()  # restartable: stop() leaves the event set
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"obs-fleet-publisher:{self.rank}")
            self._thread.start()
            # a worker that exits cleanly between intervals must still leave
            # its final counters behind for the rank-0 merge
            atexit.register(self._publish_safe)
        return self

    def stop(self, final_publish: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # a stopped publisher must stay stopped: without the unregister,
        # stop(final_publish=False) would still publish at interpreter
        # exit, and start/stop cycles would stack exit callbacks
        atexit.unregister(self._publish_safe)
        if final_publish:
            self._publish_safe()


# ---------------------------------------------------------------------------
# metric merge
# ---------------------------------------------------------------------------

def merge_prometheus_texts(texts_by_rank: Dict[int, str],
                           label: str = "rank") -> str:
    """Merge per-rank exposition texts into one, adding ``label="r"`` to
    every sample (existing ``rank`` labels are preserved, not clobbered).
    HELP/TYPE are emitted once per family; a family whose type disagrees
    across ranks raises (that is a bug, not a merge policy question)."""
    merged: Dict[str, dict] = {}
    for rank in sorted(texts_by_rank):
        for name, fam in parse_prometheus_text(texts_by_rank[rank]).items():
            m = merged.setdefault(
                name, {"help": fam["help"], "type": fam["type"], "rows": []})
            if m["type"] != fam["type"]:
                raise ValueError(
                    f"metric {name!r} is {m['type']} on one rank and "
                    f"{fam['type']} on rank {rank}")
            for sample_name, labels, value in fam["samples"]:
                row_labels = dict(labels)
                row_labels.setdefault(label, str(rank))
                m["rows"].append((sample_name, row_labels, value))
    lines = []
    for name, m in merged.items():
        lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        for sample_name, labels, value in m["rows"]:
            if labels:
                inner = ",".join(f'{k}="{_esc(str(v))}"'
                                 for k, v in labels.items())
                lines.append(f"{sample_name}{{{inner}}} {format_value(value)}")
            else:
                lines.append(f"{sample_name} {format_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def collect_fleet_metrics(store, world: int,
                          local_rank: Optional[int] = None,
                          local_text_fn=None
                          ) -> Tuple[Dict[int, str], Dict[int, float]]:
    """Pull every rank's published exposition text from the store.
    ``local_rank`` (rank 0 serving the merge) reads its own registry LIVE
    instead of its last published snapshot. Returns ``(texts_by_rank,
    wall_by_rank)``; ranks that have not published yet are absent — the
    merge must not block a scrape on a straggler."""
    texts: Dict[int, str] = {}
    walls: Dict[int, float] = {}
    for r in range(int(world)):
        if local_rank is not None and r == int(local_rank):
            if local_text_fn is not None:
                texts[r] = local_text_fn()
            else:
                from . import to_prometheus_text

                texts[r] = to_prometheus_text()
            walls[r] = time.time()
            continue
        try:
            if not store.check(metrics_key(r)):
                continue
            doc = json.loads(store.get(metrics_key(r)))
        except Exception:
            continue  # a dead rank must not fail the whole scrape
        texts[r] = doc.get("prom", "")
        walls[r] = float(doc.get("wall", 0.0))
    return texts, walls


def merged_fleet_metrics(store, world: int,
                         local_rank: Optional[int] = None,
                         local_text_fn=None) -> str:
    """The fleet ``/metrics`` body: every reporting rank's samples with a
    ``rank`` label, plus ``paddle_fleet_*`` meta-series describing the
    aggregation itself (how many ranks merged, per-rank snapshot age)."""
    texts, walls = collect_fleet_metrics(store, world, local_rank,
                                         local_text_fn)
    now = time.time()
    meta = Registry()
    meta.gauge("paddle_fleet_world_size",
               "world size of the launched job").set(int(world))
    meta.gauge("paddle_fleet_ranks_reporting",
               "ranks whose snapshot was merged into this scrape"
               ).set(len(texts))
    age = meta.gauge("paddle_fleet_snapshot_age_seconds",
                     "age of each merged rank snapshot at scrape time")
    for r, wall in sorted(walls.items()):
        age.set(max(0.0, now - wall), rank=str(r))
    return merge_prometheus_texts(texts) + meta.to_prometheus_text()


# ---------------------------------------------------------------------------
# trace merge
# ---------------------------------------------------------------------------

def merge_chrome_traces(docs_by_rank: Dict[int, dict],
                        clocks_by_rank: Optional[Dict[int, dict]] = None
                        ) -> dict:
    """Merge per-rank chrome-trace docs into one Perfetto-loadable file:
    every event gets ``pid = rank`` (plus ``process_name`` /
    ``process_sort_index`` metadata so Perfetto shows "rank r" tracks in
    order), and — when clock anchors are available — each rank's
    ``perf_counter`` timestamps are shifted onto the lowest rank's
    timeline via the published ``(wall, perf)`` anchors."""
    if not docs_by_rank:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    clocks = clocks_by_rank or {}
    ref = min(docs_by_rank)
    ref_anchor = None
    if ref in clocks:
        ref_anchor = clocks[ref]["wall"] - clocks[ref]["perf"]
    events = []
    for rank in sorted(docs_by_rank):
        offset_us = 0
        if ref_anchor is not None and rank in clocks:
            anchor = clocks[rank]["wall"] - clocks[rank]["perf"]
            offset_us = int(round((anchor - ref_anchor) * 1e6))
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"sort_index": rank}})
        for ev in docs_by_rank[rank].get("traceEvents", []):
            out = dict(ev)
            out["pid"] = rank
            if "ts" in out:
                out["ts"] = int(out["ts"]) + offset_us
            events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def collect_fleet_trace(store, world: int,
                        local_rank: Optional[int] = None,
                        local_trace_fn=None) -> dict:
    """Pull every rank's published trace + clock anchor and merge."""
    docs: Dict[int, dict] = {}
    clocks: Dict[int, dict] = {}
    for r in range(int(world)):
        try:
            if local_rank is not None and r == int(local_rank):
                if local_trace_fn is not None:
                    docs[r] = local_trace_fn()
                else:
                    from . import get_recorder

                    docs[r] = get_recorder().to_chrome_trace()
                clocks[r] = _clock_sample()
                continue
            if store.check(trace_key(r)):
                docs[r] = json.loads(store.get(trace_key(r)))["trace"]
            if store.check(clock_key(r)):
                clocks[r] = json.loads(store.get(clock_key(r)))
        except Exception:
            continue
    return merge_chrome_traces(docs, clocks)


def _filter_tsdb_doc(doc: dict, selector: Optional[str],
                     window_s: Optional[float], now: float) -> dict:
    """Shape one rank's published tsdb dump like a live ``/query`` answer:
    matched series, best tier for the window (raw while it still covers
    the window's start, else coarse — coarse points re-emit as their
    mean)."""
    from . import tsdb as _tsdb

    series = doc.get("series", {})
    rows = []
    for sid in _tsdb.match_series(series.keys(), selector):
        ent = series[sid]
        raw = ent.get("raw") or []
        coarse = ent.get("coarse") or []
        tier, pts = "raw", raw
        if window_s is not None:
            cutoff = now - float(window_s)
            if raw and raw[0][0] > cutoff and coarse:
                tier, pts = "coarse", coarse
            pts = [p for p in pts if p[0] >= cutoff]
        rows.append({"id": sid, "kind": ent.get("kind", "gauge"),
                     "tier": tier, "points": [[p[0], p[1]] for p in pts]})
    return {"interval_s": doc.get("interval_s"), "series": rows}


def collect_fleet_tsdb(store, world: int, local_rank: Optional[int] = None,
                       selector: Optional[str] = None,
                       window_s: Optional[float] = None) -> dict:
    """The ``/fleet/query`` body: every rank's published metric history,
    keyed by rank. The serving rank answers from its live store; ranks
    without a published ``obs/tsdb/rank{r}`` key (history plane off, or
    not yet published) are absent from ``ranks``."""
    from . import tsdb as _tsdb

    now = time.time()
    ranks: Dict[str, dict] = {}
    for r in range(int(world)):
        if local_rank is not None and r == int(local_rank):
            h = _tsdb.get()
            if h is not None:
                live = h.query(selector, window_s)
                ranks[str(r)] = {"wall": now, "interval_s": live["interval_s"],
                                 "series": live["series"]}
            continue
        try:
            if not store.check(tsdb_key(r)):
                continue
            doc = json.loads(store.get(tsdb_key(r)))
        except Exception:
            continue  # a dead rank must not fail the whole query
        body = _filter_tsdb_doc(doc.get("tsdb", {}), selector, window_s, now)
        ranks[str(r)] = {"wall": doc.get("wall"), **body}
    return {"now": now, "world": int(world), "window_s": window_s,
            "series_selector": selector, "ranks": ranks}


def collect_fleet_profile(store, world: int,
                          local_rank: Optional[int] = None,
                          seconds: Optional[float] = None,
                          top: int = 30) -> dict:
    """The ``/fleet/profile`` body: every profiling rank's hot stacks
    keyed by rank, plus a fleet-wide merge (summed category counts and
    the top folded stacks across ranks — same-shape stacks on different
    ranks add up, which is exactly what a fleet flamegraph wants)."""
    from . import profiler as _profiler

    now = time.time()
    ranks: Dict[str, dict] = {}
    for r in range(int(world)):
        if local_rank is not None and r == int(local_rank):
            prof = _profiler.get()
            if prof is not None:
                ranks[str(r)] = {"wall": now,
                                 **prof.jsonable(seconds, top)}
            continue
        try:
            if not store.check(prof_key(r)):
                continue
            doc = json.loads(store.get(prof_key(r)))
        except Exception:
            continue  # a dead rank must not fail the whole merge
        ranks[str(r)] = {"wall": doc.get("wall"), **doc.get("profile", {})}
    cats: Dict[str, int] = {}
    stacks: Dict[str, int] = {}
    for body in ranks.values():
        for cat, n in (body.get("categories") or {}).items():
            cats[cat] = cats.get(cat, 0) + int(n)
        for row in body.get("top") or []:
            stacks[row["stack"]] = (stacks.get(row["stack"], 0)
                                    + int(row["samples"]))
    total = sum(stacks.values())
    # same ranking rule as SamplingProfiler.hot_stacks: burning stacks
    # first, parked (idle) stacks after all of them regardless of count
    ranked = sorted(stacks.items(),
                    key=lambda kv: (kv[0].startswith("idle;"), -kv[1],
                                    kv[0]))
    merged_top = [{"stack": s, "samples": n,
                   "category": s.split(";", 1)[0],
                   "pct": round(100.0 * n / total, 2) if total else 0.0}
                  for s, n in ranked[:max(top, 0)]]
    return {"now": now, "world": int(world), "query_seconds": seconds,
            "ranks": ranks,
            "merged": {"categories": dict(
                sorted(cats.items(), key=lambda kv: -kv[1])),
                "top": merged_top}}


def fleet_status(store, world: int) -> dict:
    """Who has published, and how stale — the ``/fleet/ranks`` body.
    Reads the few-dozen-byte clock anchor for the age, not the full
    metrics blob (same publication cycle, a fraction of the transfer)."""
    now = time.time()
    ranks = {}
    for r in range(int(world)):
        try:
            published = bool(store.check(metrics_key(r)))
            age = None
            if published and store.check(clock_key(r)):
                age = round(
                    now - json.loads(store.get(clock_key(r)))["wall"], 3)
            ranks[str(r)] = {"published": published, "age_s": age}
        except Exception as e:
            ranks[str(r)] = {"published": False,
                             "error": f"{type(e).__name__}: {e}"}
    return {"world": int(world), "ranks": ranks}


def install_fleet_routes(exporter, store, world: int,
                         local_rank: int = 0) -> None:
    """Turn one rank's exporter into the fleet view: ``/metrics`` becomes
    the rank-labeled merge (the per-rank view stays at
    ``/metrics/local``), ``/fleet/trace`` serves the merged Perfetto file,
    ``/fleet/ranks`` the publication status."""
    from .exporter import PROM_CONTENT_TYPE

    local = exporter._routes.get("/metrics")
    if local is not None:
        exporter.register_route("/metrics/local", local)
    exporter.register_route("/metrics", lambda: (
        200, PROM_CONTENT_TYPE,
        merged_fleet_metrics(store, world, local_rank)))
    exporter.register_route("/fleet/trace", lambda: (
        200, "application/json",
        json.dumps(collect_fleet_trace(store, world, local_rank))))
    exporter.register_route("/fleet/ranks", lambda: (
        200, "application/json", json.dumps(fleet_status(store, world))))

    def _fleet_query(params):
        try:
            window_s = (float(params["window"])
                        if params.get("window") else None)
        except ValueError as e:
            return (400, "application/json",
                    json.dumps({"error": f"bad parameter: {e}"}))
        return (200, "application/json", json.dumps(collect_fleet_tsdb(
            store, world, local_rank, params.get("series") or None,
            window_s)))

    exporter.register_param_route("/fleet/query", _fleet_query)

    def _fleet_profile(params):
        try:
            seconds = (float(params["seconds"])
                       if params.get("seconds") else None)
            top = int(params["top"]) if params.get("top") else 30
        except ValueError as e:
            return (400, "application/json",
                    json.dumps({"error": f"bad parameter: {e}"}))
        return (200, "application/json", json.dumps(collect_fleet_profile(
            store, world, local_rank, seconds, top), default=str))

    exporter.register_param_route("/fleet/profile", _fleet_profile)
