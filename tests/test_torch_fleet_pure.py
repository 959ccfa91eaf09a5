"""The fleet's pure functions in the port against the JAX package's, on
the same inputs: the autoscaler's policy (``FleetPolicy`` / ``decide``) and
``perf_verdict_gate``, the retry backoff (``compute_delay``), the chaos
specs and their fire sequences, the network-chaos specs, the typed-error
wire documents in both directions, the C API frames byte for byte, the
metric history's ``/query`` body after one scrape sequence, and the alert
engine's state transitions over one metric sequence.

Each pair must agree exactly: these functions are copies of jax-free
reference code, so any difference is a porting fault. Hypothesis draws the
signals and specs.
"""

import json
import random
import string
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddlepaddle_tpu.inference import c_api_server as jcapi
from paddlepaddle_tpu.inference import fleet as jfleet
from paddlepaddle_tpu.inference import robustness as jrob
from paddlepaddle_tpu.observability import alerts as jalerts
from paddlepaddle_tpu.observability import metrics as jmetrics
from paddlepaddle_tpu.observability import tsdb as jtsdb
from paddlepaddle_tpu.resilience import chaos as jchaos
from paddlepaddle_tpu.resilience import netchaos as jnet
from paddlepaddle_tpu.resilience import retry as jretry
from paddlepaddle_tpu_torch.inference import c_api_server as tcapi
from paddlepaddle_tpu_torch.inference import fleet as tfleet
from paddlepaddle_tpu_torch.inference import robustness as trob
from paddlepaddle_tpu_torch.observability import alerts as talerts
from paddlepaddle_tpu_torch.observability import metrics as tmetrics
from paddlepaddle_tpu_torch.observability import tsdb as ttsdb
from paddlepaddle_tpu_torch.resilience import chaos as tchaos
from paddlepaddle_tpu_torch.resilience import netchaos as tnet
from paddlepaddle_tpu_torch.resilience import retry as tretry

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

# -- the autoscaler's policy -------------------------------------------------

_sig = st.fixed_dictionaries({
    "replicas": st.integers(0, 6),
    "healthy": st.integers(0, 6),
    "est_wait_max": st.one_of(st.none(), st.floats(0, 5, allow_nan=False)),
    "queue_depth": st.integers(0, 8),
    "burn": st.one_of(st.none(), st.floats(0, 4, allow_nan=False)),
    "alerts": st.one_of(st.none(), st.fixed_dictionaries({
        "burn_firing": st.lists(st.sampled_from(["ttft_burn",
                                                 "tpot_burn"]),
                                max_size=2, unique=True)})),
})
_state = st.fixed_dictionaries({
    "hot": st.integers(0, 6), "idle": st.integers(0, 6),
    "last_action_t": st.one_of(st.none(), st.floats(0, 200,
                                                    allow_nan=False))})
_policy = st.fixed_dictionaries({
    "min_replicas": st.integers(1, 2), "max_replicas": st.integers(2, 5),
    "up_streak": st.integers(1, 3), "down_streak": st.integers(1, 4),
    "cooldown_up_s": st.floats(0, 30, allow_nan=False),
    "cooldown_down_s": st.floats(0, 60, allow_nan=False),
    "scale_up_est_wait_s": st.floats(0.1, 2, allow_nan=False),
    "scale_up_burn": st.floats(0.5, 2, allow_nan=False),
})


@SETTINGS
@given(pol=_policy, sigs=st.lists(_sig, min_size=1, max_size=6),
       state=_state, now=st.floats(0, 300, allow_nan=False))
def test_decide_matches_reference_over_a_tick_sequence(pol, sigs, state,
                                                       now):
    jp, tp = jfleet.FleetPolicy(**pol), tfleet.FleetPolicy(**pol)
    js, ts = dict(state), dict(state)
    for i, sig in enumerate(sigs):
        a = jfleet.decide(jp, dict(sig), js, now + i)
        b = tfleet.decide(tp, dict(sig), ts, now + i)
        assert a == b
        assert js == ts


def test_fleet_policy_defaults_match_reference():
    assert vars(tfleet.FleetPolicy()) == vars(jfleet.FleetPolicy())


@SETTINGS
@given(rows=st.lists(st.fixed_dictionaries({
    "metric": st.sampled_from(["tok_s", "ttft_p99_ms", "tpot_ms"]),
    "verdict": st.sampled_from(["ok", "regression", "missing",
                                "improvement"]),
    "baseline": st.floats(0, 100, allow_nan=False),
    "candidate": st.floats(0, 100, allow_nan=False),
    "direction": st.sampled_from(["higher", "lower"])}), max_size=5))
def test_perf_verdict_gate_matches_reference(rows):
    doc = {"fields": rows, "ok": not any(
        r["verdict"] in ("regression", "missing") for r in rows)}
    for form in (doc, json.dumps(doc)):
        assert tfleet.perf_verdict_gate(form)({}) \
            == jfleet.perf_verdict_gate(form)({})


# -- retry backoff -----------------------------------------------------------

@SETTINGS
@given(attempt=st.integers(1, 12), base=st.floats(0.001, 1),
       mult=st.floats(1, 4), cap=st.floats(0.01, 10),
       jitter=st.floats(0, 1), seed=st.integers(0, 2 ** 31))
def test_compute_delay_matches_reference(attempt, base, mult, cap, jitter,
                                         seed):
    kw = dict(max_attempts=5, base_delay=base, multiplier=mult,
              max_delay=cap, jitter=jitter)
    a = jretry.compute_delay(jretry.RetryPolicy(**kw), attempt,
                             random.Random(seed))
    b = tretry.compute_delay(tretry.RetryPolicy(**kw), attempt,
                             random.Random(seed))
    assert a == b


# -- chaos specs and their fire sequence -------------------------------------

_spec = st.builds(
    lambda point, mode, sched, arg: ":".join(
        [point, mode, sched] + ([arg] if arg else [])),
    st.sampled_from(["serving.admit", "serving.decode", "step"]),
    st.sampled_from(["exc", "latency"]),
    st.one_of(st.sampled_from(["0.25", "0.5", "1.0"]),
              st.integers(1, 5).map(lambda n: f"@{n}"),
              st.integers(1, 4).map(lambda n: f"%{n}"),
              st.integers(1, 4).map(lambda n: f"x{n}")),
    st.sampled_from(["", "0"]))


def _fires(mod, text, seed, point, hits):
    mod.configure(text, seed=seed)
    try:
        out = []
        for _ in range(hits):
            try:
                mod.chaos_point(point)
                out.append(0)
            except mod.ChaosError:
                out.append(1)
        return out, mod.fire_counts(), mod.hit_counts()
    finally:
        mod.disable()


@SETTINGS
@given(specs=st.lists(_spec, min_size=1, max_size=3),
       seed=st.integers(0, 2 ** 20))
def test_chaos_specs_and_fire_sequence_match_reference(specs, seed):
    text = ";".join(specs)
    a = [repr(s) for s in jchaos.parse_specs(text)]
    b = [repr(s) for s in tchaos.parse_specs(text)]
    assert a == b
    # latency specs sleep: keep the sequence to the exception-raising ones
    exc_only = ";".join(s.replace(":latency:", ":exc:") for s in specs)
    for point in ("serving.admit", "serving.decode"):
        assert _fires(tchaos, exc_only, seed, point, 24) \
            == _fires(jchaos, exc_only, seed, point, 24)


def test_chaos_point_stream_is_crc32_of_point_xor_seed():
    """The documented derivation: a probability spec at one point draws
    from ``random.Random(crc32(point) ^ seed)``."""
    seed = 1234
    tchaos.configure("serving.decode:exc:0.5", seed=seed)
    try:
        got = []
        for _ in range(32):
            try:
                tchaos.chaos_point("serving.decode")
                got.append(0)
            except tchaos.ChaosError:
                got.append(1)
    finally:
        tchaos.disable()
    rng = random.Random(zlib.crc32(b"serving.decode") ^ seed)
    assert got == [int(rng.random() < 0.5) for _ in range(32)]


def test_chaos_bad_specs_rejected_like_reference():
    for bad in ("nope", "a:boom:0.5", "a:exc:@x", "a:exc"):
        errs = []
        for mod in (jchaos, tchaos):
            try:
                mod.parse_specs(bad)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


_net = st.builds(
    lambda point, mode, sched: f"{point}:{mode}:{sched}",
    st.sampled_from(["up", "down", "conn", "sideways"]),
    st.sampled_from(["delay", "blackhole", "reset", "trunc", "corrupt",
                     "throttle"]),
    st.one_of(st.sampled_from(["0.1", "1.0"]),
              st.integers(1, 5).map(lambda n: f"@{n}"),
              st.integers(1, 3).map(lambda n: f"x{n}")))


@SETTINGS
@given(specs=st.lists(_net, min_size=1, max_size=3))
def test_parse_netchaos_matches_reference(specs):
    text = ";".join(specs)
    outs = []
    for mod in (jnet, tnet):
        try:
            outs.append([(s.point, s.mode, s.sched_kind, s.sched_value,
                          s.arg) for s in mod.parse_netchaos(text)])
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    assert tnet.NETCHAOS_POINTS == jnet.NETCHAOS_POINTS
    assert tnet.NETCHAOS_MODES == jnet.NETCHAOS_MODES


# -- typed errors across the wire, both directions ---------------------------

def _errors(mod):
    return [
        mod.ServerOverloadedError("full", queue_depth=7, retry_after_s=0.25),
        mod.CircuitOpenError("open", retry_after_s=1.5),
        mod.KVCapacityError("too big", pages_needed=9, pages_capacity=4),
        mod.FleetUnavailableError("none", replicas=3, healthy=0,
                                  retry_after_s=0.5),
        mod.DeployError("gate", stage="canary", reasons=["ttft"]),
        mod.ReplicaStalledError("silent", stalled_after_s=2.0),
        mod.WireCorruptionError("crc"),
        mod.RequestValidationError("bad prompt"),
        mod.DeadlineExceededError("late"),
        mod.RequestCancelledError("gone"),
        mod.EngineDrainingError("draining"),
        RuntimeError("engine blew up"),
        TimeoutError("slow"),
        KeyError("odd"),
    ]


@pytest.mark.parametrize("src,dst", [(jrob, trob), (trob, jrob)],
                         ids=["reference_to_port", "port_to_reference"])
def test_error_wire_documents_rehydrate_across_packages(src, dst):
    for a, b in zip(_errors(src), _errors(dst)):
        doc = json.loads(json.dumps(src.error_to_wire(a)))
        assert doc == dst.error_to_wire(b)
        back = dst.error_from_wire(doc)
        assert type(back).__name__ == type(dst.error_from_wire(
            dst.error_to_wire(b))).__name__
        assert str(back) == str(dst.error_from_wire(dst.error_to_wire(b)))
        if isinstance(b, dst.ServingError):
            assert type(back) is type(b)
            for f in dst._WIRE_FIELDS.get(type(b).__name__, ()):
                assert getattr(back, f) == getattr(b, f)


# -- frames, byte for byte ---------------------------------------------------

_arrays = st.builds(
    lambda dt, shape, seed: (np.random.default_rng(seed).integers(
        0, 200, size=shape).astype(dt)),
    st.sampled_from([np.float32, np.int64, np.int32, np.uint8]),
    st.lists(st.integers(0, 5), min_size=0, max_size=3).map(tuple),
    st.integers(0, 1000))


@SETTINGS
@given(arr=_arrays,
       name=st.text(string.ascii_letters + string.digits + "_",
                    max_size=12),
       doc=st.dictionaries(st.sampled_from(["ev", "n", "trace"]),
                           st.integers(0, 99), max_size=3))
def test_frames_byte_equal_to_reference(arr, name, doc):
    t = tcapi._pack_tensor(name, arr)
    assert t == jcapi._pack_tensor(name, arr)
    back_name, back = tcapi._unpack_tensor(tcapi._Cursor(t))
    assert back_name == name and back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    frame = tcapi.CApiServer(None, port=0)._reply_json(
        tcapi._ST_CHUNK, doc, t)
    assert frame == jcapi.CApiServer(None, port=0)._reply_json(
        jcapi._ST_CHUNK, doc, t)
    assert tcapi.crc_wrap(frame) == jcapi.crc_wrap(frame)
    for mod in (tcapi, jcapi):
        assert mod.crc_wrap(frame)[4] == frame[4] | mod._ST_CRC_FLAG


def test_protocol_constants_match_reference():
    names = [n for n in vars(jcapi) if n.startswith(("_OP_", "_ST_"))
             or n in ("_MAGIC", "_MAX_FRAME", "_HB_INTERVAL_S")]
    assert names
    for n in names:
        assert getattr(tcapi, n) == getattr(jcapi, n), n


# -- the metric history and the alert engine ---------------------------------

def _scrape(metrics_mod, tsdb_mod, seq):
    reg = metrics_mod.Registry()
    c = reg.counter("paddle_serving_requests_total", "requests")
    g = reg.gauge("paddle_serving_queue_depth", "queue")
    h = reg.histogram("paddle_serving_ttft_seconds", "ttft")
    h.observe(0.5)
    hist = tsdb_mod.MetricHistory(reg, interval_s=1.0, capacity=16)
    for t, (dc, gv, obs) in enumerate(seq):
        c.inc(dc)
        g.set(gv)
        for v in obs:
            h.observe(v)
        hist.observe(now=1000.0 + 2.0 * t)
    return hist


@SETTINGS
@given(seq=st.lists(st.tuples(
    st.integers(0, 20), st.floats(0, 50, allow_nan=False, width=32),
    st.lists(st.sampled_from([0.0005, 0.004, 0.03, 0.2, 0.9, 2.5]),
             max_size=6)),
    min_size=1, max_size=25),
    sel=st.sampled_from([None, "paddle_serving_ttft_seconds:p99",
                         "paddle_serving_requests_total", "paddle_*"]),
    window=st.sampled_from([None, 5.0, 30.0, 600.0]),
    max_points=st.sampled_from([None, 3]))
def test_query_body_after_one_scrape_sequence_matches_reference(
        seq, sel, window, max_points):
    a = _scrape(jmetrics, jtsdb, seq).query(sel, window,
                                            max_points=max_points,
                                            now=1000.0 + 2.0 * len(seq))
    b = _scrape(tmetrics, ttsdb, seq).query(sel, window,
                                            max_points=max_points,
                                            now=1000.0 + 2.0 * len(seq))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_query_body_routes_match_reference_with_plane_on_and_off():
    for mod in (jtsdb, ttsdb):
        mod.disable()
    assert ttsdb.query_body("x", 10.0) == jtsdb.query_body("x", 10.0)
    regs = []
    try:
        for mmod, tmod in ((jmetrics, jtsdb), (tmetrics, ttsdb)):
            reg = mmod.Registry()
            reg.gauge("paddle_g", "g").set(3.0)
            hist = tmod.MetricHistory(reg, interval_s=1.0, capacity=8)
            hist.observe(now=5.0)
            tmod._hist = hist
            regs.append(hist)
        a = json.loads(jtsdb.query_body("paddle_g", None)[2])
        b = json.loads(ttsdb.query_body("paddle_g", None)[2])
        a.pop("now"), b.pop("now")          # the wall clock of each call
        assert a == b and a["enabled"] is True
    finally:
        for mod in (jtsdb, ttsdb):
            mod._hist = None


def _alert_run(metrics_mod, tsdb_mod, alerts_mod, values, for_s):
    reg = metrics_mod.Registry()
    g = reg.gauge("paddle_slo_burn_ttft", "burn")
    hist = tsdb_mod.MetricHistory(reg, interval_s=1.0, capacity=64)
    rule = alerts_mod.AlertRule(
        "ttft_burn",
        [alerts_mod.AlertCondition("paddle_slo_burn_ttft", 10.0, "avg",
                                   ">", 1.0),
         alerts_mod.AlertCondition("paddle_slo_burn_ttft", 60.0, "avg",
                                   ">", 1.0)],
        for_s=for_s, severity="warn")
    eng = alerts_mod.AlertEngine(hist, rules=[rule], registry=reg)
    out = []
    for t, v in enumerate(values):
        g.set(v)
        hist.observe(now=100.0 + t)
        s = eng.states["ttft_burn"]
        out.append((s.state, s.since, s.fired_total))
    snap = eng.snapshot()
    return out, json.dumps(snap, sort_keys=True, default=str)


@SETTINGS
@given(values=st.lists(st.sampled_from([0.0, 0.5, 2.0, 30.0]),
                       min_size=1, max_size=60),
       for_s=st.sampled_from([0.0, 3.0]))
def test_alert_state_transitions_match_reference(values, for_s):
    a = _alert_run(jmetrics, jtsdb, jalerts, values, for_s)
    b = _alert_run(tmetrics, ttsdb, talerts, values, for_s)
    assert a == b


def test_default_rules_are_the_references():
    """The reference's default ruleset (alerts.py:303, ``ttft_burn`` to
    ``fleet_snapshot_stale``) over its metric names, rule for rule."""
    a = [r.jsonable() for r in jalerts.default_rules()]
    b = [r.jsonable() for r in talerts.default_rules()]
    assert len(b) == 12
    assert [r["name"] for r in a] == [r["name"] for r in b]
    for x, y in zip(a, b):
        x = dict(x, description=None)
        y = dict(y, description=None)
        assert x == y
