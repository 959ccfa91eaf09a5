"""The port's rank-0 fleet view (``paddlepaddle_tpu_torch/observability/
aggregate.py``, the ``obs_export`` autostart) against the JAX package's
(``paddlepaddle_tpu/observability/aggregate.py``) on the CPU.

* ``merge_prometheus_texts`` and ``merge_chrome_traces`` give the JAX
  package's output on the same inputs, string for string and event for
  event.
* A ``FleetPublisher`` (rank 1) and rank 0's exporter with
  ``install_fleet_routes`` over one port ``TCPStore``: the merged
  ``/metrics``, ``/metrics/local``, ``/fleet/trace``, ``/fleet/ranks``,
  ``/fleet/query`` and ``/fleet/profile``; ``stop_exporter`` stops an
  autostarted publisher.
* The counterpart of the JAX package's ``tests/test_fleet_telemetry.py``
  :693 through the port's launcher: two workers launched with
  ``--obs_export`` (``tests/torch_fleet_job.py``); rank 0 serves a merged
  ``/metrics`` with ``rank="0"`` and ``rank="1"`` series, ``/fleet/ranks``
  lists both, ``/fleet/trace`` has one pid per rank with a train-step span,
  and a span both ranks record on one event lands, after the anchors'
  offsets, within 0.5 s on both ranks' timelines (the polling interval and
  the anchors' error, not equality). The launcher's own exporter (armed by
  the environment) lets rank 0's port go.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from paddlepaddle_tpu.observability import aggregate as jagg
import paddlepaddle_tpu_torch.observability as obs
from paddlepaddle_tpu_torch.distributed.store import TCPStore
from paddlepaddle_tpu_torch.observability import aggregate, exporter
from paddlepaddle_tpu_torch.observability.metrics import parse_prometheus_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = os.path.join(ROOT, "tests", "torch_fleet_job.py")

_T0 = ('# HELP paddle_demo_total a demo counter\n'
       '# TYPE paddle_demo_total counter\n'
       'paddle_demo_total{op="add"} 3\n'
       '# HELP paddle_demo_seconds a demo histogram\n'
       '# TYPE paddle_demo_seconds histogram\n'
       'paddle_demo_seconds_bucket{le="0.1"} 1\n'
       'paddle_demo_seconds_bucket{le="+Inf"} 2\n'
       'paddle_demo_seconds_sum 0.35\n'
       'paddle_demo_seconds_count 2\n')
_T1 = ('# HELP paddle_demo_total a demo counter\n'
       '# TYPE paddle_demo_total counter\n'
       'paddle_demo_total{op="add"} 5\n'
       '# HELP paddle_demo_depth a demo gauge\n'
       '# TYPE paddle_demo_depth gauge\n'
       'paddle_demo_depth 2\n')


@pytest.fixture
def clean_obs():
    obs.disable()
    obs.reset()
    exporter.stop()
    yield obs
    obs.disable()
    obs.reset()
    exporter.stop()


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_merges_equal_the_reference():
    pre = ('# HELP x_total h\n# TYPE x_total counter\n'
           'x_total{rank="9"} 1\n')
    for texts in ({0: _T0, 1: _T1}, {0: pre}, {3: _T1, 1: _T0}, {}):
        assert aggregate.merge_prometheus_texts(texts) == \
            jagg.merge_prometheus_texts(texts)
    merged = aggregate.merge_prometheus_texts({0: _T0, 1: _T1})
    assert 'paddle_demo_total{op="add",rank="1"} 5' in merged
    assert merged.count("# TYPE paddle_demo_total counter") == 1
    with pytest.raises(ValueError):
        aggregate.merge_prometheus_texts({0: _T1, 1: _T1.replace(
            "paddle_demo_depth gauge", "paddle_demo_depth counter")})
    doc0 = {"traceEvents": [
        {"name": "step", "ph": "X", "ts": 1000, "dur": 10, "pid": 0,
         "tid": 1}, {"name": "c", "ph": "C", "ts": 1500, "pid": 3,
                     "args": {"v": 1}}], "displayTimeUnit": "ms"}
    doc1 = {"traceEvents": [
        {"name": "step", "ph": "X", "ts": 1000, "dur": 10, "pid": 0,
         "tid": 7}], "displayTimeUnit": "ms"}
    clocks = {0: {"wall": 100.0, "perf": 50.0},
              1: {"wall": 100.0, "perf": 48.0}}
    for docs, cl in (({0: doc0, 1: doc1}, clocks), ({0: doc0, 1: doc1}, None),
                     ({1: doc1}, {1: clocks[1]}), ({}, None)):
        assert aggregate.merge_chrome_traces(docs, cl) == \
            jagg.merge_chrome_traces(docs, cl)
    spans = [e for e in aggregate.merge_chrome_traces(
        {0: doc0, 1: doc1}, clocks)["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"]: e["ts"] for e in spans} == {0: 1000, 1: 2_001_000}


def test_publisher_and_rank0_routes_over_one_store(clean_obs):
    store = TCPStore("127.0.0.1", 0, is_master=True)
    trace1 = {"traceEvents": [{"name": "w1", "ph": "X", "ts": 5, "dur": 1,
                               "pid": 0, "tid": 2}], "displayTimeUnit": "ms"}
    hist1 = {"interval_s": 2.0, "series": {"paddle_demo_depth": {
        "kind": "gauge", "raw": [[time.time(), 2.0]], "coarse": []}}}
    pub = aggregate.FleetPublisher(
        store, rank=1, interval_s=0.1, text_fn=lambda: _T1,
        trace_fn=lambda: trace1, tsdb_fn=lambda: hist1).start()
    try:
        obs.enable(trace=True, metrics=True, watchdog_=False)
        obs.safe_inc("paddle_local_total", "a rank-0 counter")
        with obs.RecordEvent("r0_span"):
            pass
        with exporter.TelemetryExporter(port=0) as e:
            aggregate.install_fleet_routes(e, store, world=2, local_rank=0)
            deadline = time.time() + 20
            fams = {}
            while time.time() < deadline:
                status, body = _get(e.url("/metrics"))
                assert status == 200
                fams = parse_prometheus_text(body.decode())
                if "paddle_demo_total" in fams:
                    break
                time.sleep(0.05)
            assert any(lab.get("rank") == "0" for _, lab, _ in
                       fams["paddle_local_total"]["samples"])
            assert any(lab.get("rank") == "1" for _, lab, _ in
                       fams["paddle_demo_total"]["samples"])
            (reporting,) = [v for _, _, v in
                            fams["paddle_fleet_ranks_reporting"]["samples"]]
            assert reporting == 2
            status, body = _get(e.url("/metrics/local"))
            assert status == 200 and "rank=" not in body.decode()
            merged = json.loads(_get(e.url("/fleet/trace"))[1])
            assert {ev["pid"] for ev in merged["traceEvents"]} == {0, 1}
            assert any(ev.get("name") == "w1" and ev["pid"] == 1
                       for ev in merged["traceEvents"])
            assert any(ev.get("name") == "r0_span" and ev["pid"] == 0
                       for ev in merged["traceEvents"])
            ranks = json.loads(_get(e.url("/fleet/ranks"))[1])["ranks"]
            assert ranks["1"]["published"] is True
            assert ranks["1"]["age_s"] is not None
            q = json.loads(_get(e.url("/fleet/query?window=600"))[1])
            assert q["world"] == 2
            assert q["ranks"]["1"]["series"][0]["id"] == "paddle_demo_depth"
            assert _get(e.url("/fleet/query?window=x"))[0] == 400
            prof = json.loads(_get(e.url("/fleet/profile"))[1])
            assert prof["world"] == 2 and "merged" in prof
    finally:
        pub.stop(final_publish=False)


def test_stop_exporter_stops_the_autostarted_publisher(clean_obs):
    store = TCPStore("127.0.0.1", 0, is_master=True)
    pub = aggregate.FleetPublisher(store, rank=3, interval_s=60,
                                   text_fn=lambda: _T0).start()
    obs._fleet_publisher = pub
    obs._fleet_stopped = False
    try:
        obs.stop_exporter()
        assert obs._fleet_publisher is None and obs._fleet_stopped
        assert pub._thread is None
        # a late autostart after the stop stops itself
        obs._autostart_fleet()
        assert obs._fleet_publisher is None
    finally:
        obs._fleet_stopped = False


def _free_ports():
    """A port p with p + 1 free too (rank r's exporter listens on p + r)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue


def test_launch_two_workers_rank0_serves_fleet_metrics_and_trace(tmp_path):
    go, stop = str(tmp_path / "go"), str(tmp_path / "stop")
    base_port = _free_ports()
    env = dict(os.environ, DRILL_GO=go, DRILL_STOP=stop,
               PADDLE_OBS_PUBLISH_INTERVAL_S="0.3",
               # the launcher's own environment arms its exporter too: it
               # must let rank 0's port go before the workers start
               PADDLE_OBS_EXPORT="1", PADDLE_OBS_PORT=str(base_port))
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    log = open(tmp_path / "launch.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlepaddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--obs_export", "--obs_port",
         str(base_port), JOB], stdout=log, stderr=subprocess.STDOUT,
        env=env, cwd=ROOT)

    def tail():
        return open(tmp_path / "launch.log").read()[-3000:]

    try:
        fams, deadline = {}, time.time() + 180
        while time.time() < deadline:
            assert proc.poll() is None, tail()
            try:
                status, body = _get(f"http://127.0.0.1:{base_port}/metrics",
                                    timeout=5)
            except (OSError, urllib.error.URLError):
                time.sleep(0.3)
                continue
            if status == 200:
                fams = parse_prometheus_text(body.decode())
                samples = fams.get("paddle_dataloader_batches_total",
                                   {}).get("samples", [])
                if {lab.get("rank") for _, lab, _ in samples} >= {"0", "1"}:
                    break
            time.sleep(0.3)
        samples = fams.get("paddle_dataloader_batches_total",
                           {}).get("samples", [])
        assert {lab.get("rank") for _, lab, _ in samples} >= {"0", "1"}, \
            tail()
        (reporting,) = [v for _, _, v in
                        fams["paddle_fleet_ranks_reporting"]["samples"]]
        assert reporting == 2
        status, body = _get(f"http://127.0.0.1:{base_port + 1}/healthz")
        assert status == 200 and json.loads(body)["rank"] == 1
        ranks = json.loads(_get(
            f"http://127.0.0.1:{base_port}/fleet/ranks")[1])["ranks"]
        assert ranks["0"]["published"] and ranks["1"]["published"]
        # both ranks record go_seen when the file appears
        open(go, "w").close()
        deadline, marks = time.time() + 60, {}
        while time.time() < deadline:
            status, body = _get(f"http://127.0.0.1:{base_port}/fleet/trace",
                                timeout=30)
            assert status == 200
            merged = json.loads(body)
            marks = {ev["pid"]: ev["ts"] for ev in merged["traceEvents"]
                     if ev.get("name") == "go_seen"}
            if len(marks) == 2:
                break
            time.sleep(0.3)
        assert merged["displayTimeUnit"] == "ms"
        span_pids = {ev["pid"] for ev in merged["traceEvents"]
                     if ev.get("ph") == "X" and ev["name"] == "train_step"}
        assert span_pids == {0, 1}
        assert set(marks) == {0, 1}, marks
        assert abs(marks[1] - marks[0]) < 500_000, marks
    finally:
        open(stop, "w").close()
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        log.close()
    assert rc == 0, tail()
