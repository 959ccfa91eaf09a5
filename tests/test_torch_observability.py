"""The port's observability planes against the JAX package's, on the CPU.

Both packages keep their own module-level planes (registry, recorder,
journeys, goodput ledger), so one process drives both side by side. The
port has no eager-dispatch, autograd, collective, comm-task or data-loader
hooks yet (ROADMAP A10, A11), so the reference's metrics of those planes
(``EXCLUDED``) are the only names allowed to differ.

Tolerances, each with its reason:
* metric text, metric names, label sets, counter values, journey span names
  and goodput counts: exact — they follow from the calls and the traffic;
* a train step's counted FLOPs against XLA's ``cost_analysis`` of the
  reference's step: within 5% — the matmul FLOPs agree exactly (2 per
  multiply-add on both sides), and the elementwise work is counted per
  operation of each framework's own decomposition (measured on this
  configuration: 44,583,335 against 45,331,532, 1.7% apart);
* the decode engine's program costs against the reference's programs:
  within 10% — the two engines do different work at the edges: the
  reference's bucketed admission attends over the whole ``max_len`` cache
  (256 keys here) where the port's eager prefill attends over the prompt's
  own 128 (measured 0.922 of the reference's FLOPs), and the port's decode
  chunk samples and attends through other operations (measured 1.040).

No wall-clock assertion: timings are the card's business (chip_smoke.py).
"""

import gc
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.observability as jobs
from paddlepaddle_tpu.inference.serving import ServingEngine as JServing
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import llama as jl
from paddlepaddle_tpu.observability import metrics as jmetrics
from paddlepaddle_tpu.optimizer.optimizers import AdamW as JAdamW
from paddlepaddle_tpu_torch import TrainStep, convert
from paddlepaddle_tpu_torch import observability as tobs
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (GenerationRequest,
                                                      ServingEngine)
from paddlepaddle_tpu_torch.models import llama as tl
from paddlepaddle_tpu_torch.observability import (flight, goodput,
                                                  memledger, metrics, perf,
                                                  profiler, reqtrace,
                                                  watchdog)
from paddlepaddle_tpu_torch.optimizer import AdamW

EXCLUDED = {
    "paddle_op_calls_total", "paddle_op_seconds", "paddle_amp_casts_total",
    "paddle_autograd_nodes_captured_total",
    "paddle_autograd_nodes_executed_total", "paddle_autograd_node_seconds",
    "paddle_comm_task_seconds", "paddle_collective_calls_total",
    "paddle_collective_bytes_total", "paddle_collective_seconds",
    "paddle_dataloader_wait_seconds", "paddle_dataloader_queue_depth",
    "paddle_dataloader_batches_total",
}

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256, dtype="float32")


@pytest.fixture
def clean():
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.reqtrace.disable()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.reqtrace.disable()
        o.perf.disable()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**CFG))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(tm, state)
    return jm, tm


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 128, 32)
    return [np.concatenate([shared, rng.integers(1, 128, n)])
            for n in (5, 9, 20, 3, 12)]


# -- metrics ---------------------------------------------------------------

def _script(reg):
    c = reg.counter("paddle_x_total", "a counter")
    c.inc()
    c.inc(2.5, op="mat\"mul", site="a\\b")
    c.inc(3, op="add\nx")
    g = reg.gauge("paddle_g", "a gauge")
    g.set(7)
    g.set(1e20, k="big")
    g.dec(0.25, k="small")
    h = reg.histogram("paddle_h_seconds", "a histogram",
                      buckets=reg_buckets(reg))
    for v in (1e-6, 3e-4, 0.5, 2.0, 1e9, 0.0):
        h.observe(v)
        h.observe(v * 2, route="r1")
    reg.histogram("paddle_default_seconds", "default ladder").observe(1e-3)
    reg.counter("paddle_empty_total", "never incremented")


def reg_buckets(reg):
    mod = jmetrics if isinstance(reg, jmetrics.Registry) else metrics
    return mod.exponential_buckets(1e-4, 4.0, 8)


def test_metrics_text_byte_equal_to_reference():
    jr, tr = jmetrics.Registry(), metrics.Registry()
    _script(jr)
    _script(tr)
    text = tr.to_prometheus_text()
    assert text == jr.to_prometheus_text()
    assert metrics.snapshot_to_jsonable(tr.snapshot()) == \
        jmetrics.snapshot_to_jsonable(jr.snapshot())
    fams = metrics.parse_prometheus_text(text)
    assert fams == jmetrics.parse_prometheus_text(text)
    assert fams["paddle_x_total"]["type"] == "counter"
    labels = {tuple(sorted(lb.items())): v
              for _, lb, v in fams["paddle_x_total"]["samples"]}
    assert labels[(("op", 'mat"mul'), ("site", "a\\b"))] == 2.5
    assert labels[(("op", "add\nx"),)] == 3
    assert any(n == "paddle_h_seconds_bucket" and lb.get("le") == "+Inf"
               for n, lb, _ in fams["paddle_h_seconds"]["samples"])
    with pytest.raises(ValueError):
        metrics.parse_prometheus_text("paddle_orphan 1\n")


# -- serving with observability on ----------------------------------------

def _serve(obs, engine_cls, model, **kw):
    obs.enable(trace=False, metrics=True, watchdog_=False)
    obs.reqtrace.enable()
    se = engine_cls(model, max_batch_size=4, max_len=128, kv_page_size=16,
                    decode_chunk=4, **kw)
    try:
        futs = [se.submit(p, max_new_tokens=6, prefix_len=32)
                for p in _prompts()]
        outs = [f.result(300) for f in futs]
        health = se.health()
        health["tokens_out"] = se._engine.stats["tokens_out"]
    finally:
        se.stop()
    journeys = sorted((j.jsonable() for j in obs.reqtrace.journeys()),
                      key=lambda j: j["req_id"])
    return obs.snapshot(), journeys, health, outs


def _collapse(names):
    """Span names with consecutive repeats folded: how many decode chunks a
    request sees depends on when the engine thread admitted it."""
    out = []
    for n in names:
        if not out or out[-1] != n:
            out.append(n)
    return out


TRAFFIC_COUNTERS = (
    "paddle_serving_requests_total", "paddle_goodput_tokens_total",
    "paddle_serving_kv_prefix_hits_total",
    "paddle_serving_spec_proposed_total",
    "paddle_serving_spec_accepted_total",
    "paddle_serving_spec_accept_run_length_total",
    "paddle_serving_kv_pages_total", "paddle_serving_spec_k",
)


@pytest.mark.parametrize("spec", [False, True], ids=["paged", "spec"])
def test_served_workload_metrics_journeys_goodput_match_reference(
        models, clean, spec):
    jm, tm = models
    jkw, tkw = {}, {}
    if spec:
        jkw, tkw = dict(draft=jm, spec_k=2), dict(draft=tm, spec_k=2)
    jsnap, jjour, jh, jout = _serve(jobs, JServing, jm, **jkw)
    tsnap, tjour, th, tout = _serve(tobs, ServingEngine, tm, device="cpu",
                                    **tkw)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)
    # names with a sample (a reset keeps registrations, empty, as in the
    # reference, so names registered by earlier tests read empty here)
    jsnap = {n: v for n, v in jsnap.items() if v}
    tsnap = {n: v for n, v in tsnap.items() if v}
    assert set(jsnap) - EXCLUDED == set(tsnap)
    for name in tsnap:
        assert sorted(tsnap[name]) == sorted(jsnap[name]), name
    for name in TRAFFIC_COUNTERS:
        assert tsnap.get(name) == jsnap.get(name), name
    for hist in ("paddle_serving_ttft_seconds", "paddle_serving_tpot_seconds",
                 "paddle_serving_queue_wait_seconds",
                 "paddle_serving_request_seconds"):
        assert ({k: v["count"] for k, v in tsnap[hist].items()}
                == {k: v["count"] for k, v in jsnap[hist].items()}), hist
    assert len(tjour) == len(jjour) == len(_prompts())
    for a, b in zip(jjour, tjour):
        assert a["outcome"] == b["outcome"] == "ok"
        an = [s["name"] for s in a["spans"]]
        bn = [s["name"] for s in b["spans"]]
        assert _collapse(bn) == _collapse(an)
        for name in set(an):
            ka = {k for s in a["spans"] if s["name"] == name for k in s}
            kb = {k for s in b["spans"] if s["name"] == name for k in s}
            assert kb == ka, name
        assert a["slo"].keys() == b["slo"].keys()
    assert th["goodput"]["kinds"] == jh["goodput"]["kinds"]
    # the ledger's identity: every decoded token attributed exactly once
    decoded = sum(th["goodput"]["kinds"][k] for k in goodput.DECODED_KINDS)
    assert decoded == th["tokens_out"] == jh["tokens_out"]
    assert th["compile"]["programs_warmed"] == jh["compile"]["programs_warmed"]
    assert th["compile"]["plan"]["entries"] == jh["compile"]["plan"]["entries"]


def test_cancel_and_deadline_waste_reach_the_goodput_ledger(models, clean):
    _, tm = models
    eng = BatchDecodeEngine(tm, max_slots=2, max_len=128, page_size=16,
                            chunk=4, device="cpu")
    reqs = [GenerationRequest(p, 20) for p in _prompts()[:2]]
    for r in reqs:
        assert eng._admit(r)
    eng._decode_chunk()
    emitted = [len(s.emitted) for s in eng._host_slots]
    eng.release_slot(0, reason="deadline")
    eng.release_slot(1)
    kinds = goodput.snapshot()["kinds"]
    assert kinds["deadline"] == emitted[0] and kinds["cancel"] == emitted[1]
    assert memledger.leak_check(eng)["leaked_pages"] == 0


def test_serving_leaves_no_leaked_page_and_memledger_attributes(models,
                                                                clean):
    _, tm = models
    eng = BatchDecodeEngine(tm, max_slots=4, max_len=128, page_size=16,
                            chunk=4, device="cpu", kv_host_bytes=1 << 20)
    reqs = [GenerationRequest(p, 6, prefix_len=32) for p in _prompts()]
    eng.serve(reqs, timeout=120)
    check = memledger.leak_check(eng)
    assert check["leaked_pages"] == 0 and check["tier_overlap"] == 0
    assert check["prefix_pages"] == 2        # the shared 32-token prefix
    gc.collect()              # engines of earlier tests hold cycles
    assert memledger.live_engines() == [eng]
    sample = memledger.sample_now()
    assert sample["sampled"] and sample["leaked_pages"] == 0
    b = sample["buckets"]
    assert b["params"] == sum(t.numel() * 4 for t in
                              list(tm.parameters()) + list(tm.buffers()))
    assert b["prefix_pinned"] == 2 * eng.kv_stats()["page_bytes"]
    assert b["kv_pages"] + b["prefix_pinned"] == eng.kv_stats()["kv_bytes"]
    # no card here: the allocator feeds stay unset, as on the reference's
    # backends without memory_stats
    assert sample["device_bytes_in_use"] is None
    assert sample["headroom_ratio"] is None
    snap = tobs.snapshot()
    assert snap["paddle_mem_leaked_pages"][()] == 0


# -- planes ----------------------------------------------------------------

def test_flight_recorder_dumps_engine_events(models, clean, tmp_path):
    _, tm = models
    flight.enable(directory=str(tmp_path), install_hooks=False)
    try:
        se = ServingEngine(tm, max_batch_size=2, max_len=128,
                           kv_page_size=16, device="cpu")
        se.generate(_prompts()[0], max_new_tokens=3, timeout=60)
        se.stop()
        path = flight.dump("test")
    finally:
        flight.disable()
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["rec"] == "header" and "serving_kv" in \
        lines[0]["annotations"]
    phases = [e["data"]["phase"] for e in lines
              if e.get("rec") == "event" and e["kind"] == "request"]
    assert phases == ["submit", "admit", "finish"]
    assert lines[-1]["rec"] == "end"


def test_watchdog_counts_planned_and_unplanned_builds(clean):
    storms = []
    watchdog.install(threshold=2)
    watchdog.set_storm_callback(lambda site, n: storms.append((site, n)))
    try:
        with watchdog.expected_compiles("warmup"):
            for _ in range(3):
                watchdog.record_compile("capture", "decode", 0.01)
        assert storms == [] and watchdog.unplanned_counts() == {}
        watchdog.record_compile("build", "paged_attention", 1.0)
        watchdog.record_compile("build", "paged_attention", 1.0)
        assert storms == [("build:paged_attention", 2)]
        assert watchdog.compile_counts() == {"capture:decode": 3,
                                             "build:paged_attention": 2}
        assert "storm" in watchdog.report()
    finally:
        watchdog.set_storm_callback(None)
        watchdog.uninstall()


def test_profiler_classifies_port_seams():
    assert profiler.classify([("llama.py", "forward"),
                              ("decode_engine.py", "_admit_paged_impl"),
                              ("decode_engine.py", "_admit")]) == "admission"
    assert profiler.classify([("llama.py", "forward"),
                              ("decode_engine.py", "_decode_body")]) == "decode"
    assert profiler.classify([("speculative.py", "verify_body")]) == "decode"
    assert profiler.classify([("threading.py", "wait"),
                              ("decode_engine.py", "_decode_chunk")]) == "idle"
    p = profiler.SamplingProfiler(hz=10)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="parked")
    t.start()
    try:
        assert p.sample_once(now=100.0) >= 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert sum(p.categories(None, now=100.0).values()) == p.samples


def test_exporter_serves_the_default_routes(models, clean):
    _, tm = models
    tobs.enable(trace=True, metrics=True, watchdog_=True)
    reqtrace.enable()
    ex = tobs.start_exporter(port=0)
    se = ServingEngine(tm, max_batch_size=2, max_len=128, kv_page_size=16,
                       device="cpu")
    try:
        se.generate(_prompts()[1], max_new_tokens=3, timeout=60)

        def get(path):
            try:
                with urllib.request.urlopen(ex.url(path), timeout=30) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        status, text = get("/metrics")
        fams = metrics.parse_prometheus_text(text)
        assert status == 200
        assert fams["paddle_serving_requests_total"]["samples"][0][2] == 1
        status, body = get("/healthz")
        health = json.loads(body)
        assert status == 200 and health["providers"]["serving"]["ok"]
        assert json.loads(get("/")[1])["routes"] == sorted(
            ["/", "/metrics", "/healthz", "/vars", "/trace", "/programs",
             "/requests", "/requests/trace", "/query", "/alerts", "/profile",
             "/mem"])
        assert json.loads(get("/requests")[1])["journeys"][0]["outcome"] \
            == "ok"
        assert json.loads(get("/requests/trace")[1])["traceEvents"]
        assert json.loads(get("/vars")[1])["paddle_serving_requests_total"]
        assert get("/query?window=10")[1] == json.dumps(
            {"enabled": False, "series": []})
        assert json.loads(get("/alerts")[1]) == {"enabled": False,
                                                 "rules": []}
        assert get("/profile")[0] == 503
        assert json.loads(get("/mem")[1])["leaked_pages"] == 0
        assert "device" in json.loads(get("/programs")[1])
        assert any(e["name"] == "serving.decode_chunk"
                   for e in json.loads(get("/trace")[1])["traceEvents"])
    finally:
        se.stop()
        tobs.stop_exporter()
    assert "serving" not in ex._health_providers


# -- perf plane --------------------------------------------------------------

def test_known_matmul_flops_exact_through_the_registry(clean):
    perf.enable()
    M, K, N = 128, 64, 32
    a, b = torch.ones(M, K), torch.ones(K, N)
    with perf.counting("t.matmul", bucket="mkn") as c:
        out = a @ b
    assert float(out[0, 0]) == K
    assert c.flops == 2 * M * K * N
    assert c.bytes_accessed == (M * K + K * N + M * N) * 4
    perf.observe("t.matmul", 1e-3, bucket="mkn")
    row = {(r["program"], r["bucket"]): r
           for r in perf.registry().table()}[("t.matmul", "mkn")]
    assert row["flops"] == 2 * M * K * N and row["calls"] == 1
    assert row["cost_source"] == "counted"
    text = tobs.to_prometheus_text()
    assert 'paddle_program_flops{bucket="mkn",program="t.matmul"}' in text
    metrics.parse_prometheus_text(text)


def test_device_peaks_hold_the_h100_and_no_guess():
    from paddlepaddle_tpu_torch.observability.perf import device

    assert device._lookup("NVIDIA H100 80GB HBM3", "gpu") == (989e12,
                                                              3.35e12)
    assert device._lookup("NVIDIA A100-SXM4-80GB", "gpu") == (None, None)
    assert device._lookup("cpu", "cpu") == (1e12, 100e9)
    assert device.specs()["platform"] == "cpu"
    row = perf.costs.ProgramCost("p", "")
    row.flops, row.bytes_accessed, row.calls, row.wall_min = 1.0, 1.0, 1, 1.0
    assert "mfu" not in row.derived({"peak_flops": None})


def _train_pair():
    cfg = dict(CFG, max_position_embeddings=64)
    paddle.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**cfg))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig(**cfg), device="cpu")
    convert.load_jax_state(tm, state)
    return jm, tm


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)


def test_train_step_cost_matches_reference_flops(clean):
    jm, tm = _train_pair()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
    jobs.perf.enable()
    perf.enable()
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()), _loss_fn)
    jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    step = TrainStep(tm, AdamW(learning_rate=1e-3,
                               parameters=list(tm.parameters())),
                     _loss_fn, device="cpu")
    step(ids, ids)
    step(ids, ids)                    # counted once, at the first call
    jrow = {r["program"]: r for r in jobs.perf.registry().table()}
    trow = {r["program"]: r for r in perf.registry().table()}
    want, got = jrow["train.step"], trow["train.step"]
    assert got["bucket"] == want["bucket"] == "accum1"
    assert got["model"] == want["model"] == "LlamaForCausalLM"
    assert abs(got["flops"] - want["flops"]) <= 0.05 * want["flops"]


def test_steptimeline_phases_sum_to_wall(clean):
    tobs.enable(trace=True, metrics=True, watchdog_=False)
    tl_ = perf.timeline()
    rec = tobs.get_recorder()
    for _ in range(3):
        with tl_.step("train"):
            rec.record_complete("all_reduce", "collective", 0.002)
            rec.record_complete("dataloader_wait", "dataloader", 0.001)
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.005)
    snap = tl_.snapshot()
    assert snap["count"] == 3 and snap["untraced"] == 0
    for s in snap["last"]:
        assert sum(s["phases"].values()) == pytest.approx(s["wall_s"],
                                                          rel=1e-9)
        assert s["phases"]["comm"] == pytest.approx(0.002, abs=1e-6)
        assert s["phases"]["data_wait"] == pytest.approx(0.001, abs=1e-6)
    assert tobs.snapshot()["paddle_steps_total"][()] == 3
    assert "Step time decomposition" in tobs.summary()


def test_decode_engine_program_costs_match_reference_flops(models, clean):
    """The engine's per-program capture (reference decode_engine.py:145):
    the decode chunk and the admissions at their buckets, held against
    XLA's counts of the reference's programs on the same traffic."""
    from paddlepaddle_tpu.inference.decode_engine import \
        BatchDecodeEngine as JEngine
    from paddlepaddle_tpu.inference.serving import \
        GenerationRequest as JRequest

    jm, tm = models
    jobs.perf.enable()
    perf.enable()
    prompts = [np.arange(1, 129) % 120 + 1]           # one 128-token bucket
    kw = dict(max_slots=2, max_len=256, page_size=16, chunk=4)
    JEngine(jm, **kw).serve([JRequest(p, 6, 0.0, 0, None) for p in prompts])
    BatchDecodeEngine(tm, device="cpu", **kw).serve(
        [GenerationRequest(p, 6) for p in prompts])
    jrow = {(r["program"], r["bucket"]): r
            for r in jobs.perf.registry().table()}
    trow = {(r["program"], r["bucket"]): r for r in perf.registry().table()}
    # the port's engine attends through the paged wrapper (its plain
    # version on the CPU), so its decode row carries the "-fused" bucket
    for jkey, tkey in ((("serving.admit", "p128"),) * 2,
                       (("serving.decode", "s2c4"),
                        ("serving.decode", "s2c4-fused"))):
        want, got = jrow[jkey]["flops"], trow[tkey]["flops"]
        assert abs(got - want) <= 0.10 * want, (jkey, got, want)
