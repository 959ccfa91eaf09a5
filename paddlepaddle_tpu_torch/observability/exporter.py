"""Per-rank HTTP telemetry exporter — the pull half of the fleet plane.

The port's own copy of the jax-free ``paddlepaddle_tpu/observability/
exporter.py``, with the reference's default routes (:161-172): ``/query``
reads the metric history (``tsdb``) and ``/alerts`` the alert engine, which
``observability.enable_history()`` arms; ``/healthz`` carries the alert
engine's block when one is installed. On rank 0 of a launched job
:mod:`~.aggregate` adds the fleet view (``/fleet/*``, the merged
``/metrics``). Nothing starts at import unless ``PADDLE_OBS_EXPORT=1``
(``observability`` then calls :func:`start`); otherwise call it
(``observability.start_exporter()``).

Reference surface: the reference serving stack exposes monitor stats over
an HTTP scrape endpoint per process; Prometheus convention is one exporter
per worker, aggregation downstream. This module serves the process-local
observability state on ``FLAGS_obs_port + rank`` (so every worker of a
multi-process node gets its own port) from a stdlib ``ThreadingHTTPServer``
on a daemon thread — zero dependencies, no interaction with the training
loop beyond reading the registry/recorder:

* ``/metrics``  — Prometheus exposition text (``to_prometheus_text()``);
  on rank 0 of a launched job, :mod:`~.aggregate` swaps this route for the
  fleet-merged view with a ``rank`` label per series;
* ``/healthz``  — JSON readiness: rank/world/pid, which obs subsystems are
  on, plus any registered health providers (a started
  :class:`~..inference.serving.ServingEngine` registers its ``health()``
  here); 503 when any provider reports not-ok;
* ``/vars``     — the full metrics ``snapshot()`` as JSON;
* ``/trace``    — the host span ring buffer as chrome-trace JSON (load in
  Perfetto directly);
* ``/programs`` — the perf plane's program-cost table (XLA FLOPs/bytes,
  measured wall, roofline classification) as JSON; rendered by
  ``obsctl programs``;
* ``/requests`` — recent + in-flight request journeys (reqtrace) with
  SLO-histogram exemplars and the burn-rate block, as strict JSON;
  ``/requests/trace`` serves the same journeys as Perfetto-loadable
  chrome-trace JSON (one track per replica); rendered by
  ``obsctl requests``;
* ``/query``    — metric history from the tsdb plane
  (``?series=<selector>&window=<seconds>``, strict JSON); on rank 0 of a
  launched job :mod:`~.aggregate` adds ``/fleet/query`` with every rank's
  published history; rendered by ``obsctl query`` and ``obsctl top``;
* ``/alerts``   — the alert engine's rule states as strict JSON; a firing
  page-severity rule also flips ``/healthz`` to 503 via its built-in
  ``alerts`` provider block.

Auto-started per worker when ``PADDLE_OBS_EXPORT=1`` (``FLAGS_obs_export``)
— ``distributed.launch --obs_export`` sets that for every rank it spawns.
If the deterministic port is taken, the exporter falls back to an ephemeral
port and says so on stderr rather than dying: telemetry must never take the
worker down.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..core import flags as _flags
from .flight import _rank, _world

__all__ = ["TelemetryExporter", "start", "stop", "get", "PROM_CONTENT_TYPE"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_JSON = "application/json"

# route callable: () -> (http_status, content_type, body_str_or_bytes)
Route = Callable[[], Tuple[int, str, object]]
# param route callable: (query_params_dict) -> same tuple
ParamRoute = Callable[[Dict[str, str]], Tuple[int, str, object]]


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-obs"

    def do_GET(self):  # noqa: N802 (http.server API)
        exporter = self.server._exporter  # type: ignore[attr-defined]
        raw_path, _, query = self.path.partition("?")
        path = raw_path.rstrip("/") or "/"
        proute = exporter._param_routes.get(path)
        route = exporter._routes.get(path)
        if proute is None and route is None:
            body = json.dumps({"error": f"no route {path}",
                               "routes": exporter.route_names()})
            self._send(404, _JSON, body)
            return
        try:
            if proute is not None:
                from urllib.parse import parse_qsl

                status, ctype, body = proute(dict(parse_qsl(query)))
            else:
                status, ctype, body = route()
        except Exception as e:  # a broken route must not kill the server
            status, ctype = 500, _JSON
            body = json.dumps({"error": f"{type(e).__name__}: {e}"})
        self._send(status, ctype, body)

    def _send(self, status: int, ctype: str, body) -> None:
        data = body if isinstance(body, bytes) else str(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # scrapes must not spam worker stderr
        pass


class TelemetryExporter:
    """One process's telemetry server. ``port=None`` resolves to
    ``FLAGS_obs_port + rank``; ``port=0`` binds ephemeral (tests)."""

    def __init__(self, port: Optional[int] = None, host: Optional[str] = None):
        self.host = host or _flags.flag_value("obs_export_host")
        self._requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_mono: Optional[float] = None
        self._health_providers: Dict[str, Callable[[], dict]] = {}
        self._routes: Dict[str, Route] = {}
        self._param_routes: Dict[str, ParamRoute] = {}
        self._install_default_routes()

    # -- routes --------------------------------------------------------------
    def register_route(self, path: str, fn: Route) -> None:
        """Add (or replace — the fleet aggregator replaces ``/metrics``) a
        GET route. ``fn`` returns (status, content_type, body)."""
        self._routes[path.rstrip("/") or "/"] = fn

    def register_param_route(self, path: str, fn: ParamRoute) -> None:
        """Like :meth:`register_route` but ``fn`` receives the parsed
        query-string parameters (``/query?series=&window=`` style routes);
        a path registered here shadows any plain route at the same path."""
        self._param_routes[path.rstrip("/") or "/"] = fn

    def route_names(self):
        return sorted(set(self._routes) | set(self._param_routes))

    def register_health(self, name: str, fn: Callable[[], dict],
                        unique: bool = False) -> str:
        """Attach a named health provider; its dict lands under
        ``providers`` in ``/healthz`` and its ``ok`` key gates the 503.
        With ``unique=True`` a taken name gets a ``-2``/``-3`` suffix
        instead of clobbering another provider (two serving engines in one
        process must not overwrite each other). Returns the name used."""
        if unique:
            base, n = name, 2
            while (name in self._health_providers
                   and self._health_providers[name] != fn):
                name = f"{base}-{n}"
                n += 1
        self._health_providers[name] = fn
        return name

    def unregister_health(self, name: str,
                          fn: Optional[Callable[[], dict]] = None) -> None:
        """Remove a provider. Passing ``fn`` makes it a guarded remove:
        the entry is only dropped if it still belongs to that callable."""
        if fn is not None and self._health_providers.get(name) != fn:
            return
        self._health_providers.pop(name, None)

    def _install_default_routes(self) -> None:
        self.register_route("/", self._index)
        self.register_route("/metrics", self._metrics)
        self.register_route("/healthz", self._healthz)
        self.register_route("/vars", self._vars)
        self.register_route("/trace", self._trace)
        self.register_route("/programs", self._programs)
        self.register_route("/requests", self._requests)
        self.register_route("/requests/trace", self._requests_trace)
        self.register_param_route("/query", self._query)
        self.register_route("/alerts", self._alerts)
        self.register_param_route("/profile", self._profile)
        self.register_route("/mem", self._mem)

    def _index(self):
        return 200, _JSON, json.dumps(
            {"routes": self.route_names(), "rank": _rank(),
             "world": _world(), "pid": os.getpid()})

    def _metrics(self):
        from . import to_prometheus_text

        return 200, PROM_CONTENT_TYPE, to_prometheus_text()

    def _vars(self):
        from . import snapshot
        from .metrics import snapshot_to_jsonable

        # allow_nan=False enforces the strict-JSON contract: any non-finite
        # value snapshot_to_jsonable missed fails loudly here, not in a
        # consumer's JSON parser
        return 200, _JSON, json.dumps(snapshot_to_jsonable(snapshot()),
                                      allow_nan=False)

    def _trace(self):
        from . import get_recorder

        return 200, _JSON, json.dumps(get_recorder().to_chrome_trace())

    def _programs(self):
        from . import perf

        body = dict(perf.table_jsonable(), enabled=perf.enabled(),
                    rank=_rank())
        return 200, _JSON, json.dumps(body, allow_nan=False, default=str)

    def _requests(self):
        from . import reqtrace

        body = dict(reqtrace.requests_jsonable(), rank=_rank())
        return 200, _JSON, json.dumps(body, allow_nan=False, default=str)

    def _requests_trace(self):
        from . import reqtrace

        return 200, _JSON, json.dumps(reqtrace.to_chrome_trace(),
                                      allow_nan=False, default=str)

    def _query(self, params: Dict[str, str]):
        from . import tsdb

        try:
            window_s = (float(params["window"])
                        if params.get("window") else None)
            max_points = (int(params["max_points"])
                          if params.get("max_points") else None)
        except ValueError as e:
            return 400, _JSON, json.dumps({"error": f"bad parameter: {e}"})
        return tsdb.query_body(params.get("series") or None, window_s,
                               max_points)

    def _alerts(self):
        from . import alerts

        return alerts.alerts_body()

    def _profile(self, params: Dict[str, str]):
        """Sampling-profiler read side: ``/profile?seconds=&format=
        collapsed|json&top=``; ``?device=<seconds>`` opens an on-demand
        ``torch.profiler`` device-trace window instead and returns its
        output directory."""
        from . import profiler

        prof = profiler.get()
        if prof is None:
            return 503, _JSON, json.dumps(
                {"enabled": False,
                 "error": "profiler not armed (set PADDLE_OBS_PROF=1 or "
                          "call observability.profiler.enable())"})
        try:
            seconds = (float(params["seconds"])
                       if params.get("seconds") else 10.0)
            top = int(params["top"]) if params.get("top") else 30
            device = (float(params["device"])
                      if params.get("device") else None)
        except ValueError as e:
            return 400, _JSON, json.dumps({"error": f"bad parameter: {e}"})
        if device is not None:
            try:
                outdir = prof.device_trace(seconds=device)
            except Exception as e:
                return 409, _JSON, json.dumps({"error": repr(e)})
            return 200, _JSON, json.dumps(
                {"device_trace": outdir, "seconds": device})
        if params.get("format") == "collapsed":
            return (200, "text/plain; charset=utf-8",
                    prof.collapsed(seconds))
        body = dict(prof.jsonable(seconds, top), enabled=True,
                    rank=_rank())
        return 200, _JSON, json.dumps(body, allow_nan=False, default=str)

    def _mem(self):
        """Memory-ledger read side: last bucketed sample + deltas. Takes
        a fresh sample on demand so ``obsctl mem`` works without the
        periodic thread armed."""
        from . import memledger

        try:
            body = dict(memledger.sample_now(), rank=_rank())
        except Exception as e:
            return 503, _JSON, json.dumps({"error": repr(e)})
        return 200, _JSON, json.dumps(body, allow_nan=False, default=str)

    def _healthz(self):
        from . import _metrics_on, _trace_on, _watchdog_on
        from . import flight

        providers = {}
        ok = True
        # built-in provider: the alert engine (when installed) — a firing
        # page-severity rule must flip readiness without any registration
        # ordering between engine install and exporter start
        try:
            from . import alerts as _alerts

            eng = _alerts.get()
            if eng is not None:
                snap = eng.health()
                providers["alerts"] = snap
                ok = ok and bool(snap.get("ok", True))
        except Exception:
            pass
        for name, fn in list(self._health_providers.items()):
            try:
                snap = fn()
                providers[name] = snap
                ok = ok and bool(snap.get("ok", True))
            except Exception as e:
                providers[name] = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"}
                ok = False
        body = {
            "ok": ok,
            "rank": _rank(),
            "world": _world(),
            "pid": os.getpid(),
            "port": self.port,
            "uptime_s": (None if self._started_mono is None
                         else round(time.monotonic() - self._started_mono, 3)),
            "obs": {"trace": _trace_on, "metrics": _metrics_on,
                    "recompile_watch": _watchdog_on,
                    "blackbox": flight.is_enabled()},
            "providers": providers,
        }
        return (200 if ok else 503), _JSON, json.dumps(body, default=str)

    # -- lifecycle -----------------------------------------------------------
    def resolved_port(self) -> int:
        if self._requested_port is not None:
            return int(self._requested_port)
        return int(_flags.flag_value("obs_port")) + _rank()

    def start(self) -> "TelemetryExporter":
        if self._server is not None:
            return self
        port = self.resolved_port()
        try:
            server = ThreadingHTTPServer((self.host, port), _Handler)
        except OSError as e:
            # deterministic port taken (another worker, a stale process):
            # serve anyway on an ephemeral port and say where
            server = ThreadingHTTPServer((self.host, 0), _Handler)
            sys.stderr.write(
                f"[obs] exporter port {port} unavailable ({e}); "
                f"falling back to {server.server_address[1]}\n")
        server.daemon_threads = True
        server._exporter = self  # type: ignore[attr-defined]
        self._server = server
        self.port = server.server_address[1]
        self._started_mono = time.monotonic()
        self._thread = threading.Thread(
            target=server.serve_forever, daemon=True,
            name=f"obs-exporter:{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -- module singleton (what auto-start and ServingEngine registration use) --

_exporter: Optional[TelemetryExporter] = None


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> TelemetryExporter:
    """Start (or return) the process-wide exporter."""
    global _exporter
    if _exporter is None:
        _exporter = TelemetryExporter(port=port, host=host).start()
    return _exporter


def stop() -> None:
    global _exporter
    if _exporter is not None:
        _exporter.stop()
        _exporter = None


def get() -> Optional[TelemetryExporter]:
    return _exporter
