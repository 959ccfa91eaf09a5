"""Runtime observability of the port — host spans, a metrics registry, a
capture-and-build watchdog, and the serving planes around them.

Port of ``paddlepaddle_tpu/observability/__init__.py``. One subsystem
provides:

* :class:`~.recorder.Recorder` — host span recorder (thread-local nesting,
  ring buffer, chrome-trace JSON export); each explicit span also opens a
  ``torch.profiler.record_function``, so it lands in a ``torch.profiler``
  timeline beside the card's kernels;
* :class:`~.metrics.Registry` — counters / gauges / histograms with
  ``snapshot()`` and ``to_prometheus_text()`` (the reference's text, byte
  for byte);
* :mod:`~.watchdog` — counts CUDA-graph captures and kernel builds and
  names a storm of unplanned ones;
* the serving hook (request latency, SLO histograms, batch size, queue
  depth) and the planes: :mod:`~.flight` (crash black box), :mod:`~.reqtrace`
  (per-request journeys), :mod:`~.goodput` (useful vs wasted tokens),
  :mod:`~.perf` (program costs, step timeline), :mod:`~.memledger`,
  :mod:`~.profiler` and :mod:`~.exporter` (``/metrics`` and friends).

The reference also hooks eager dispatch, autograd, collectives, comm tasks
and the data loader (:304-318). Of those the port has the eager
collectives (A10's core, :mod:`..distributed.collective`), whose hook
counts calls, bytes and wall time as the reference's does, the comm tasks
(:mod:`..distributed.comm_task`: ``paddle_comm_task_seconds`` by task and
group) and the data loader (:mod:`..io.dataloader`: the wait histogram and
a ``dataloader`` span a batch, which the step-time decomposition reads as
``data_wait``, the prefetch depth and the batches delivered); dispatch and
autograd come with ROADMAP A11. The metric history (:mod:`~.tsdb`) and the
alert engine (:mod:`~.alerts`) start when :func:`enable_history` is called.
The fleet view (:mod:`~.aggregate`): with ``PADDLE_OBS_EXPORT=1`` (what
``distributed.launch --obs_export`` sets) every worker starts its exporter
at import and, under a multi-process launch, a publisher into the job's
store; rank 0's exporter serves the merged ``/metrics`` and ``/fleet/*``
(:func:`_autostart_fleet`).

Everything is gated by ``PADDLE_OBS_*`` env vars / ``FLAGS_obs_*`` flags and
defaults OFF: the only cost on a hot path when disabled is one module-global
``is None`` check. Turn it on::

    import paddlepaddle_tpu_torch.observability as obs
    obs.enable()                       # trace + metrics + watchdog
    ... serve or train ...
    print(obs.summary())
    obs.export_chrome_trace("host_trace.json")     # open in Perfetto
    text = obs.to_prometheus_text()                # or obs.start_exporter()

or set ``PADDLE_OBS_TRACE=1 PADDLE_OBS_METRICS=1 PADDLE_OBS_RECOMPILE_WATCH=1``
(and ``PADDLE_OBS_BLACKBOX``, ``PADDLE_OBS_REQTRACE``, ``PADDLE_OBS_PERF``)
before import (``PADDLE_OBS_EXPORT`` also starts the exporter). The
profiler and the memory ledger start only when called:
``profiler.enable()``, ``memledger.enable()``.
"""

from __future__ import annotations

import os
from typing import Optional

from ..core import flags as _flags
from . import flight, goodput, memledger, perf, profiler, reqtrace, watchdog
from .metrics import (  # noqa: F401
    BYTES_BUCKETS,
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    exponential_buckets,
)
from .recorder import Event, Recorder, trace_region  # noqa: F401

_recorder = Recorder(capacity=_flags.flag_value("obs_buffer_size"))
_registry = Registry()
_trace_on = False
_metrics_on = False
_watchdog_on = False


# -- state accessors (hot-path helpers, also used by recorder/watchdog) ------

def get_recorder() -> Recorder:
    return _recorder


def get_registry() -> Registry:
    return _registry


def _recorder_if_tracing() -> Optional[Recorder]:
    return _recorder if _trace_on else None


def _metrics_if_enabled() -> Optional[Registry]:
    return _registry if _metrics_on else None


def is_enabled() -> bool:
    return _trace_on or _metrics_on or _watchdog_on


def safe_inc(name: str, help_: str = "", n: float = 1, **labels) -> None:
    """Best-effort counter increment for COLD-path events (sheds, breaker
    flips, drains, prefix hits): always records — operators must see fault
    handling even without ``enable()`` — and never raises, because fault
    handling must not fail on account of metrics."""
    try:
        _registry.counter(name, help_).inc(n, **labels)
    except Exception:
        pass


def safe_set(name: str, help_: str = "", value: float = 0.0,
             **labels) -> None:
    """Best-effort gauge write, same contract as :func:`safe_inc`."""
    try:
        _registry.gauge(name, help_).set(value, **labels)
    except Exception:
        pass


class RecordEvent(trace_region):
    """Explicit host annotation: always records (no flags needed), opens
    a ``torch.profiler.record_function``, and is a comm task of group
    ``region`` while it is open, so a watchdog timeout names the region
    (reference ``profiler/__init__.py:81-91``)."""

    def __init__(self, name: str, cat: str = "region"):
        super().__init__(name, cat, force=True)
        self._task = None

    def __enter__(self):
        from ..distributed import comm_task as _ct

        self._task = _ct.begin_task(self.name, group="region")
        return super().__enter__()

    def __exit__(self, *exc):
        from ..distributed import comm_task as _ct

        try:
            return super().__exit__(*exc)
        finally:
            if self._task is not None:
                _ct.end_task(self._task)
                self._task = None


# ---------------------------------------------------------------------------
# hot-path hook bodies, installed into the instrumented modules' nullable
# module globals by enable(); metric objects are resolved once here so the
# per-event work is dict-free.
# ---------------------------------------------------------------------------

def _slo_aligned_buckets(flag_name: str):
    """Latency bucket ladder with the armed SLO threshold inserted as an
    exact edge, so burn accounting happens AT the SLO boundary. ``None``
    (the default ladder) when the SLO flag is unarmed."""
    ms = _flags.flag_value(flag_name)
    if not ms or float(ms) <= 0:
        return None
    edge = float(ms) / 1e3
    buckets = list(LATENCY_BUCKETS)
    if edge not in buckets:
        import bisect

        bisect.insort(buckets, edge)
    return buckets


def _make_hooks():
    """The serving, collective, comm-task and data-loader hooks (reference
    :141-297, its ``srv``, ``coll``, ``task`` and ``io`` parts). The op,
    AMP and autograd hooks have no instrumented module in the port
    (ROADMAP A11)."""
    reg = _registry
    rec = _recorder

    comm_lat = reg.histogram("paddle_comm_task_seconds",
                             "host-blocking comm/region task latency")
    coll_calls = reg.counter("paddle_collective_calls_total",
                             "eager collective calls, by collective")
    coll_bytes = reg.counter("paddle_collective_bytes_total",
                             "tensor bytes moved by eager collectives")
    coll_lat = reg.histogram("paddle_collective_seconds",
                             "eager collective wall time, by collective")

    def obs_task(name, group, elapsed):
        if _metrics_on:
            comm_lat.observe(elapsed, task=name, group=group or "")
        # "region" tasks are RecordEvents, already recorder spans
        if _trace_on and group != "region":
            rec.record_complete(name, "comm", elapsed,
                                {"group": group} if group else None)

    def obs_coll(op, nbytes, dur):
        if _metrics_on:
            coll_calls.inc(coll=op)
            if nbytes:
                coll_bytes.inc(nbytes, coll=op)
            coll_lat.observe(dur, coll=op)
        if _trace_on:
            rec.record_complete(op, "collective", dur,
                                {"bytes": nbytes} if nbytes else None)

    io_wait = reg.histogram("paddle_dataloader_wait_seconds",
                            "time the loop blocked waiting on the loader")
    io_depth = reg.gauge("paddle_dataloader_queue_depth",
                         "prefetched batches sitting in the data queue")
    io_batches = reg.counter("paddle_dataloader_batches_total",
                             "batches delivered to the training loop")

    def obs_io(event, value):
        if event == "wait":
            if _metrics_on:
                io_wait.observe(value)
            if _trace_on:
                # a "dataloader" span so the step timeline attributes
                # blocked-on-input time as its own phase
                rec.record_complete("dataloader_wait", "dataloader", value)
            return
        if not _metrics_on:
            return
        if event == "qdepth":
            io_depth.set(value)
        elif event == "batch":
            io_batches.inc(value)

    srv_requests = reg.counter("paddle_serving_requests_total",
                               "generation requests completed, by outcome")
    srv_lat = reg.histogram("paddle_serving_request_seconds",
                            "submit-to-result generation latency")
    srv_batch = reg.gauge("paddle_serving_batch_size",
                          "active decode slots / batched requests")
    srv_qdepth = reg.gauge("paddle_serving_queue_depth",
                           "generation requests waiting for a decode slot")
    srv_batches = reg.counter("paddle_serving_batches_total",
                              "decode attempts, by outcome (ok/error)")
    srv_ttft = reg.histogram("paddle_serving_ttft_seconds",
                             "submit-to-first-token latency (TTFT)",
                             buckets=_slo_aligned_buckets("slo_ttft_ms"))
    srv_tpot = reg.histogram("paddle_serving_tpot_seconds",
                             "per-output-token latency after the first "
                             "(TPOT, per-request average)",
                             buckets=_slo_aligned_buckets("slo_tpot_ms"))
    srv_qwait = reg.histogram("paddle_serving_queue_wait_seconds",
                              "submit-to-decode-slot-admission queue wait")
    srv_margin = reg.histogram("paddle_serving_deadline_margin_seconds",
                               "seconds left on the request deadline at "
                               "completion (near-zero = deadlines too tight)")

    def obs_srv(event, value):
        if event == "slo":
            obs_slo(value)
            return
        if not _metrics_on:
            return
        if event == "latency":
            srv_lat.observe(value)
            srv_requests.inc(outcome="ok")
        elif event == "error":
            srv_requests.inc(outcome="error")
        elif event == "cancelled":
            srv_requests.inc(outcome="cancelled")
        elif event == "batch_size":
            srv_batch.set(value)
        elif event == "queue_depth":
            srv_qdepth.set(value)
        elif event == "batch":
            srv_batches.inc(outcome=value)

    def obs_slo(d):
        """One completed request's lifecycle numbers (dict from the
        serving engine): SLO histograms + a request span in the trace."""
        if _metrics_on:
            if d.get("ttft") is not None:
                srv_ttft.observe(d["ttft"])
            if d.get("tpot") is not None:
                srv_tpot.observe(d["tpot"])
            if d.get("queue_wait") is not None:
                srv_qwait.observe(d["queue_wait"])
            if d.get("deadline_margin") is not None:
                srv_margin.observe(d["deadline_margin"])
        if _trace_on and d.get("latency") is not None:
            rec.record_complete(
                f"request#{d.get('id', '?')}", "serving.request",
                d["latency"],
                {k: v for k, v in d.items()
                 if k != "latency" and v is not None})

    return {"srv": obs_srv, "coll": obs_coll, "task": obs_task,
            "io": obs_io}


def _set_hooks(hooks: Optional[dict]) -> None:
    """Install (or clear, with None) the nullable hook global of the
    instrumented module (the serving engine). Never raises."""
    g = (lambda k: None) if hooks is None else hooks.get
    try:
        from ..inference import serving as _srv

        _srv._obs_srv = g("srv")
    except Exception:
        pass
    try:
        from ..distributed import collective as _coll
        from ..distributed import comm_task as _ct

        _coll._obs_coll = g("coll")
        _ct._obs_task = g("task")
    except Exception:
        pass
    try:
        from ..io import dataloader as _dl

        _dl._obs_io = g("io")
    except Exception:
        pass


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enable(trace: Optional[bool] = None, metrics: Optional[bool] = None,
           watchdog_: Optional[bool] = None) -> None:
    """Turn instrumentation on. ``None`` arguments fall back to the
    ``FLAGS_obs_*`` flags (i.e. the ``PADDLE_OBS_*`` env vars); calling
    ``enable()`` with no arguments and no flags set enables everything."""
    global _trace_on, _metrics_on, _watchdog_on
    if trace is None and metrics is None and watchdog_ is None \
            and not (_flags.flag_value("obs_trace")
                     or _flags.flag_value("obs_metrics")
                     or _flags.flag_value("obs_recompile_watch")):
        trace = metrics = watchdog_ = True
    _trace_on = _flags.flag_value("obs_trace") if trace is None else bool(trace)
    _metrics_on = (_flags.flag_value("obs_metrics") if metrics is None
                   else bool(metrics))
    _watchdog_on = (_flags.flag_value("obs_recompile_watch")
                    if watchdog_ is None else bool(watchdog_))
    _flags.set_flags({"obs_trace": _trace_on, "obs_metrics": _metrics_on,
                      "obs_recompile_watch": _watchdog_on})
    _recorder.set_capacity(_flags.flag_value("obs_buffer_size"))
    if _trace_on or _metrics_on:
        _set_hooks(_make_hooks())
    else:
        _set_hooks(None)
    if _watchdog_on:
        watchdog.install(_flags.flag_value("obs_recompile_threshold"))
    else:
        watchdog.uninstall()


def disable() -> None:
    """Uninstall every hook; hot paths return to the bare ``is None``
    check. Recorded data is kept — call :func:`reset` to drop it."""
    global _trace_on, _metrics_on, _watchdog_on
    _trace_on = _metrics_on = _watchdog_on = False
    _flags.set_flags({"obs_trace": False, "obs_metrics": False,
                      "obs_recompile_watch": False})
    _set_hooks(None)
    watchdog.uninstall()


def enable_history(interval_s: Optional[float] = None, rules=None,
                   start_thread: bool = True):
    """Arm the metric-history plane (:mod:`~.tsdb`) and its alert engine
    (:mod:`~.alerts`) over the package registry (reference :370).
    ``start_thread=False`` leaves the sampler to be driven by hand
    (``history.observe(now)``). Returns the :class:`~.tsdb.MetricHistory`."""
    from . import alerts as _alerts
    from . import tsdb as _tsdb

    h = _tsdb.enable(interval_s=interval_s, start_thread=start_thread)
    _alerts.install(history=h, rules=rules)
    return h


def disable_history() -> None:
    """Stop the history sampler and detach the alert engine."""
    from . import alerts as _alerts
    from . import tsdb as _tsdb

    _alerts.uninstall()
    _tsdb.disable()


def reset() -> None:
    """Clear the ring buffer, all metric values, watchdog state, the perf
    plane, the journeys and the goodput ledger, and stop the profiler, the
    memory ledger and the history and alert planes."""
    _recorder.clear()
    _registry.clear()
    watchdog.reset()
    perf.reset()
    reqtrace.reset()
    goodput.reset()
    profiler.reset()
    memledger.reset()
    disable_history()


# ---------------------------------------------------------------------------
# read-side API
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    return _registry.snapshot()


def to_prometheus_text() -> str:
    # lazy publication: every scrape sees fresh paddle_program_* roofline
    # gauges without the perf plane paying a per-step publish
    try:
        perf.publish_gauges()
    except Exception:
        pass
    return _registry.to_prometheus_text()


def export_chrome_trace(path: str) -> str:
    """Write the host span ring buffer as trace-event JSON (loadable by
    Perfetto / chrome://tracing). The card's kernels come from a
    ``torch.profiler`` trace; explicit spans opened while one is active
    also appear there."""
    return _recorder.export_chrome_trace(path)


def _section(lines, title):
    lines.append("")
    lines.append(title)
    lines.append("-" * len(title))


def summary(top: int = 30) -> str:
    """Human-readable report over everything recorded: serving, program
    rooflines, the step timeline, host spans and the capture/build table.
    Returns (and prints nothing) — callers decide where it goes."""
    snap = _registry.snapshot()
    lines = [f"paddlepaddle_tpu_torch observability summary "
             f"(trace={'on' if _trace_on else 'off'}, "
             f"metrics={'on' if _metrics_on else 'off'}, "
             f"watchdog={'on' if _watchdog_on else 'off'})",
             f"rank {flight._rank()}/{flight._world()}  pid {os.getpid()}"]

    io = snap.get("paddle_dataloader_wait_seconds", {})
    if io or snap.get("paddle_dataloader_batches_total"):
        _section(lines, "DataLoader")
        h = io.get((), {})
        batches = snap.get("paddle_dataloader_batches_total", {}).get((), 0)
        depth = snap.get("paddle_dataloader_queue_depth", {}).get((), 0)
        lines.append(f"batches={int(batches)}  queue_depth={depth:g}  "
                     f"wait_total={h.get('sum', 0.0) * 1e3:.1f}ms  "
                     f"waits={h.get('count', 0)}")

    srv = snap.get("paddle_serving_request_seconds", {})
    if srv or snap.get("paddle_serving_requests_total") \
            or snap.get("paddle_serving_shed_total"):
        _section(lines, "Serving")
        h = srv.get((), {})
        reqs = snap.get("paddle_serving_requests_total", {})
        ok = reqs.get((("outcome", "ok"),), 0)
        err = reqs.get((("outcome", "error"),), 0)
        cancelled = reqs.get((("outcome", "cancelled"),), 0)
        bs = snap.get("paddle_serving_batch_size", {}).get((), 0)
        qd = snap.get("paddle_serving_queue_depth", {}).get((), 0)
        avg = h.get("sum", 0.0) / max(h.get("count", 1), 1)
        lines.append(f"requests ok={int(ok)} err={int(err)} "
                     f"cancelled={int(cancelled)}  "
                     f"avg_latency={avg * 1e3:.2f}ms  batch_size={bs:g}  "
                     f"queue_depth={qd:g}")
        sheds = snap.get("paddle_serving_shed_total", {})
        if sheds:
            parts = " ".join(f"{dict(k).get('reason', '?')}={int(v)}"
                             for k, v in sorted(sheds.items()))
            lines.append(f"sheds: {parts}")
        breaker = snap.get("paddle_serving_breaker_state", {}).get((), None)
        if breaker is not None:
            name = {0: "closed", 1: "half_open", 2: "open"}.get(
                int(breaker), "?")
            lines.append(f"breaker: {name}")
        ttft = snap.get("paddle_serving_ttft_seconds", {}).get((), None)
        if ttft and ttft.get("count"):
            h_t = _registry.get("paddle_serving_ttft_seconds")
            tpot = snap.get("paddle_serving_tpot_seconds", {}).get((), {})
            lines.append(
                f"SLO: ttft p50={h_t.quantile(0.5) * 1e3:.1f}ms "
                f"p99={h_t.quantile(0.99) * 1e3:.1f}ms "
                f"({ttft['count']} requests)  tpot_avg="
                f"{tpot.get('sum', 0.0) / max(tpot.get('count', 1), 1) * 1e3:.2f}"
                f"ms/token")

    cost_rows = perf.registry().table()
    if cost_rows:
        _section(lines, "Program roofline (counted FLOPs x measured wall, "
                        "perf plane)")
        lines.append(perf.costs.render_table(cost_rows[:top]))

    tl = perf._timeline
    if tl is not None and tl.count:
        _section(lines, "Step time decomposition")
        lines.append(tl.render())

    region_stats = _recorder.stats()
    if region_stats and _trace_on:
        _section(lines, f"Host spans (ring buffer, "
                        f"{len(_recorder.events())} events)")
        lines.append(f"{'Span':<40}{'Count':>8}{'Total(ms)':>12}"
                     f"{'Avg(ms)':>10}")
        for name, (cnt, total, _mn, _mx) in sorted(
                region_stats.items(), key=lambda kv: -kv[1][1])[:top]:
            lines.append(f"{name:<40}{cnt:>8}{total * 1e3:>12.3f}"
                         f"{total / max(cnt, 1) * 1e3:>10.3f}")

    if watchdog.compile_counts():
        _section(lines, "captures and kernel builds (watchdog)")
        lines.append(watchdog.report())

    if len(lines) == 2:  # only the title + rank header
        lines.append("  (nothing recorded — call observability.enable() "
                     "or set PADDLE_OBS_TRACE/PADDLE_OBS_METRICS)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# telemetry exporter
# ---------------------------------------------------------------------------

_fleet_publisher = None  # the autostarted FleetPublisher, so it can be stopped
_fleet_stopped = False  # stop_exporter() may race the autostart thread


def start_exporter(port: Optional[int] = None, host: Optional[str] = None):
    """Start (or return) this process's HTTP telemetry exporter — serves
    ``/metrics``, ``/healthz``, ``/vars``, ``/trace`` & co. on
    ``FLAGS_obs_port + rank`` (``port=0``: an ephemeral port)."""
    from . import exporter

    return exporter.start(port=port, host=host)


def stop_exporter() -> None:
    """Stop the exporter AND the autostarted fleet publisher (if any):
    tearing telemetry down must not leave a thread publishing to the store.
    Safe against the autostart thread still dialling the store: the flag
    makes a late-arriving publisher stop itself."""
    global _fleet_publisher, _fleet_stopped
    from . import exporter

    _fleet_stopped = True
    exporter.stop()
    pub, _fleet_publisher = _fleet_publisher, None
    if pub is not None:
        pub.stop(final_publish=False)


def _autostart_fleet() -> None:
    """Under a multi-process launch, publish snapshots into the launcher's
    TCPStore and (on rank 0) serve the merged fleet view (reference
    :651-701). Runs on a daemon thread: the store dial must never block (or
    break) the worker's import."""
    global _fleet_publisher
    world = flight._world()
    if world <= 1 or _fleet_stopped:
        return
    try:
        from ..distributed.store import create_or_get_global_tcp_store
        from . import aggregate as _aggregate
        from . import exporter as _exporter

        rank = flight._rank()
        # torch-style jobs (RANK/WORLD_SIZE only): pin the PADDLE_* names
        # BEFORE touching the global store, as host_collectives does, or
        # the store factory would see rank 0 / world 1 and cache a wrong
        # (self-hosted) store; if the dial fails, unpin: telemetry must not
        # leave the process lying about its rank
        pinned = []
        for k, v in (("PADDLE_TRAINER_ID", rank),
                     ("PADDLE_TRAINERS_NUM", world)):
            if k not in os.environ:
                os.environ[k] = str(v)
                pinned.append(k)
        try:
            store = create_or_get_global_tcp_store()
        except BaseException:
            for k in pinned:
                os.environ.pop(k, None)
            raise
        _fleet_publisher = _aggregate.FleetPublisher(store, rank).start()
        if _fleet_stopped:  # stop_exporter() won the race mid-dial
            pub, _fleet_publisher = _fleet_publisher, None
            if pub is not None:  # stop_exporter may have swapped it first
                pub.stop(final_publish=False)
            return
        if rank == 0:
            served = _exporter.get()
            if served is not None:
                _aggregate.install_fleet_routes(served, store, world,
                                                local_rank=0)
    except Exception as e:
        import sys as _sys

        _sys.stderr.write(f"[obs] fleet telemetry autostart failed: {e!r}\n")


# arm from env: PADDLE_OBS_* / FLAGS_obs_* read at define_flag time
if (_flags.flag_value("obs_trace") or _flags.flag_value("obs_metrics")
        or _flags.flag_value("obs_recompile_watch")):
    enable(trace=_flags.flag_value("obs_trace"),
           metrics=_flags.flag_value("obs_metrics"),
           watchdog_=_flags.flag_value("obs_recompile_watch"))

if _flags.flag_value("obs_blackbox"):
    flight.enable()

if _flags.flag_value("obs_reqtrace"):
    reqtrace.enable()

if _flags.flag_value("obs_export"):
    try:
        start_exporter()
    except Exception as _e:
        import sys as _sys

        _sys.stderr.write(f"[obs] exporter autostart failed: {_e!r}\n")
    import threading as _threading

    _threading.Thread(target=_autostart_fleet, daemon=True,
                      name="obs-fleet-autostart").start()

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Recorder", "Event",
    "RecordEvent", "trace_region", "exponential_buckets",
    "enable", "disable", "reset", "is_enabled", "safe_inc", "safe_set",
    "get_recorder", "get_registry", "snapshot", "to_prometheus_text",
    "export_chrome_trace", "summary", "watchdog", "flight", "perf",
    "reqtrace", "profiler", "memledger", "goodput",
    "start_exporter", "stop_exporter",
]
