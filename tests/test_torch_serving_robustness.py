"""The port's serving protection layer (``inference/serving.py``: deadlines,
cancellation, the breaker with its hang watchdog, drain and SIGTERM,
``health()``) held against the JAX package's, mirroring
``tests/test_serving_robustness.py``.

The static-scheduler cases drive both packages' ``ServingEngine`` with one
instant fake model (a ``generate_cached`` lookalike, as the reference's
tests do) and assert the same typed errors and counters on each. The
continuous cases run the port's engine over a tiny f32 Llama on the CPU:
a cancelled or expired request's slot and pages are freed mid-decode and
the other requests' tokens equal an undisturbed run's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddlepaddle_tpu.inference.robustness as jrob
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.inference.serving import ServingEngine as JaxServing
from paddlepaddle_tpu_torch.inference import robustness as trob
from paddlepaddle_tpu_torch.inference.decode_engine import BatchDecodeEngine
from paddlepaddle_tpu_torch.inference.serving import (
    GenerationRequest,
    ServingEngine,
)
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {"jax": (JaxServing, JaxRequest, jrob),
            "port": (ServingEngine, GenerationRequest, trob)}


class _Out:
    def __init__(self, a):
        self._a = a

    def numpy(self):
        return self._a


class FakeModel:
    """generate_cached lookalike: echoes the prompt + zeros, with injectable
    latency and failures."""

    def __init__(self, delay_s=0.0, fail_next=0):
        self.delay_s = delay_s
        self.fail_next = fail_next
        self.calls = 0
        self.batch_sizes = []

    def generate_cached(self, ids, max_new_tokens, temperature=0.0, top_k=0,
                        eos_token_id=None):
        self.calls += 1
        self.batch_sizes.append(ids.shape[0])
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("synthetic decode failure")
        if self.delay_s:
            time.sleep(self.delay_s)
        return _Out(np.concatenate(
            [ids, np.zeros((ids.shape[0], max_new_tokens), np.int32)],
            axis=1))


def _prompt(n=4, v=0):
    return np.full((n,), v, np.int32)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _static(pkg, model=None, **kw):
    cls = pkg[0]
    kw.setdefault("mode", "static")
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("max_len", 64)
    return cls(model or FakeModel(), **kw)


def _await(pred, timeout=5.0):
    end = time.time() + timeout
    while time.time() < end and not pred():
        time.sleep(0.02)
    return pred()


# -- deadlines and cancellation (static scheduler, both packages) ------------

def test_deadline_expired_sheds_before_admission(pkg):
    eng = _static(pkg)
    try:
        with pytest.raises(pkg[2].DeadlineExceededError):
            eng.submit(_prompt(), max_new_tokens=2, deadline_s=0.0)
        assert eng.stats["deadline_expired"] == 1
        assert eng.stats["shed"] == 1
    finally:
        eng.stop()


def test_default_deadline_and_queued_expiry(pkg):
    model = FakeModel(delay_s=0.15)
    eng = _static(pkg, model, max_batch_size=1)
    try:
        head = eng.submit(_prompt(), max_new_tokens=2)
        doomed = eng.submit(_prompt(6), max_new_tokens=2, deadline_s=0.01)
        with pytest.raises(pkg[2].DeadlineExceededError, match="queued"):
            doomed.result(10)
        head.result(10)
        assert model.calls == 1 and all(b == 1 for b in model.batch_sizes)
    finally:
        eng.stop()
    # default_deadline_s applies to a submit that passes none
    eng = _static(pkg, FakeModel(delay_s=0.15), max_batch_size=1,
                  default_deadline_s=0.05)
    try:
        assert eng.default_deadline_s == 0.05
        head = eng.submit(_prompt(), max_new_tokens=2)
        doomed = eng.submit(_prompt(6), max_new_tokens=2)
        with pytest.raises(pkg[2].DeadlineExceededError):
            doomed.result(10)
        head.result(10)
        assert eng.stats["deadline_expired"] == 1
    finally:
        eng.stop()


def test_cancel_queued_request(pkg):
    eng = _static(pkg, FakeModel(delay_s=0.1), max_batch_size=1)
    try:
        head = eng.submit(_prompt(), max_new_tokens=2)
        queued = eng.submit(_prompt(6), max_new_tokens=2)
        assert queued.cancel() is True
        assert queued.cancelled()
        assert queued.cancel() is False       # already finished
        with pytest.raises(pkg[2].RequestCancelledError):
            queued.result(5)
        head.result(10)
        assert _await(lambda: eng.stats["cancelled"] == 1)
    finally:
        eng.stop()


# -- breaker and watchdog -----------------------------------------------------------

def test_breaker_opens_then_recovers_static(pkg):
    model = FakeModel(fail_next=3)
    eng = _static(pkg, model, max_batch_size=1, breaker_threshold=3,
                  breaker_reset_s=0.2)
    try:
        for _ in range(3):
            f = eng.submit(_prompt(), max_new_tokens=2)
            with pytest.raises(RuntimeError, match="synthetic"):
                f.result(10)
        saw_open = False
        deadline = time.time() + 2
        while time.time() < deadline:
            try:
                f = eng.submit(_prompt(), max_new_tokens=2)
                break
            except pkg[2].CircuitOpenError as e:
                saw_open = True
                assert e.retry_after_s <= 0.25
                time.sleep(0.02)
        else:
            pytest.fail("breaker never let the probe through")
        assert saw_open
        f.result(10)
        assert _await(lambda: eng._breaker.state == "closed")
        assert eng.health()["ok"]
        assert eng.stats["decode_failures"] == 3
        assert eng.stats["batches_failed"] == 3
    finally:
        eng.stop()


def test_hung_decode_watchdog_trips_breaker(pkg):
    eng = _static(pkg, FakeModel(delay_s=0.5), max_batch_size=1,
                  breaker_threshold=100, breaker_reset_s=10.0,
                  decode_timeout_s=0.05)
    try:
        slow = eng.submit(_prompt(), max_new_tokens=2)
        assert _await(lambda: eng._breaker.state == "open", 0.4)
        h = eng.health()
        assert not h["ok"] and h["decode_inflight_s"] > 0.05
        with pytest.raises(pkg[2].CircuitOpenError):
            eng.submit(_prompt(), max_new_tokens=2)
        slow.result(10)
        assert _await(lambda: eng._breaker.state == "closed")
    finally:
        eng.stop()


# -- drain, restart, SIGTERM -----------------------------------------------------------

def test_drain_finishes_inflight_and_sheds_rest(pkg):
    eng = _static(pkg, FakeModel(delay_s=0.1), max_batch_size=1)
    try:
        futs = [eng.submit(_prompt(), max_new_tokens=2) for _ in range(5)]
        res = eng.drain(timeout=0.25)
        assert all(f.done() for f in futs)
        served = shed = 0
        for f in futs:
            try:
                f.result(0)
                served += 1
            except pkg[2].EngineDrainingError:
                shed += 1
        assert served >= 1 and shed >= 1 and shed == res["shed"]
        with pytest.raises(pkg[2].EngineDrainingError):
            eng.submit(_prompt(), max_new_tokens=2)
        assert eng.health()["state"] == "stopped"
    finally:
        eng.stop()


def test_restart_after_drain_reopens_admission(pkg):
    eng = _static(pkg, breaker_threshold=2)
    try:
        eng.submit(_prompt(), max_new_tokens=2).result(10)
        eng._breaker.trip()
        assert eng.drain(timeout=5)["clean"]
        with pytest.raises(pkg[2].EngineDrainingError):
            eng.submit(_prompt(), max_new_tokens=2)
        eng.start()
        assert eng._breaker.state == "closed"
        assert eng.submit(_prompt(), max_new_tokens=2).result(10).shape \
            == (6,)
        h = eng.health()
        assert h["state"] == "serving" and h["ok"]
        res = eng.drain(timeout=5)
        assert res["clean"] and res["shed"] == 0
        assert eng.drain(timeout=1)["shed"] == 0     # idempotent
    finally:
        eng.stop()


def test_incompatible_request_not_starved(pkg):
    eng = _static(pkg, max_wait_ms=20.0)
    req = pkg[1]
    for n in (4, 8, 4, 4):
        eng._queue.put(req(_prompt(n), 2, 0.0, 0, None))
    assert [r.prompt_ids.shape[1] for r in eng._collect_batch()] == [4, 4, 4]
    assert [r.prompt_ids.shape[1] for r in eng._collect_batch()] == [8]
    eng.stop()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_sigterm_drains_before_exit_143(tmp_path, name):
    """A SIGTERM'd serving host drains through the package's preemption
    handler and exits 143 with nothing left hanging."""
    sentinel = tmp_path / "drained.json"
    script = tmp_path / "serve_and_term.py"
    mod = ("paddlepaddle_tpu" if name == "jax" else "paddlepaddle_tpu_torch")
    script.write_text(f"""
import json, os, signal, sys, time
import numpy as np
sys.path.insert(0, {_REPO!r})
sys.path.insert(0, {os.path.join(_REPO, 'tests')!r})
from test_torch_serving_robustness import FakeModel
from {mod}.inference.serving import ServingEngine
from {mod}.resilience.preemption import install_preemption_handler

eng = ServingEngine(FakeModel(delay_s=0.05), mode="static",
                    max_batch_size=1, max_len=64, drain_on_sigterm=True)
futs = [eng.submit(np.full((4,), 0, np.int32), max_new_tokens=2)
        for _ in range(3)]
results = {{}}
def snapshot():
    h = eng.health()
    results["state"] = h["state"]
    results["done"] = all(f.done() for f in futs)
    open({str(sentinel)!r}, "w").write(json.dumps(results))
install_preemption_handler(snapshot)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
""")
    proc = subprocess.run([sys.executable, str(script)], timeout=120,
                          capture_output=True, text=True,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 143, (proc.returncode, proc.stderr[-2000:])
    data = json.loads(sentinel.read_text())
    assert data == {"state": "stopped", "done": True}


# -- health ------------------------------------------------------------------------------

def test_health_keys_match_reference():
    keys = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        eng = _static(pkg)
        try:
            eng.submit(_prompt(), max_new_tokens=2).result(10)
            h = eng.health()
            keys.append(set(h))
            assert h["state"] == "serving" and h["ok"]
            assert h["inflight"] == 0 and h["stats"]["batches"] == 1
            assert h["last_decode_ok_age_s"] is not None
        finally:
            eng.stop()
    assert keys[0] == keys[1]


# -- the continuous engine (port, tiny Llama on the CPU) --------------------------------

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")


@pytest.fixture(scope="module")
def tm():
    return LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=4,
                            init_std=0.1)


def _prompts(seed, n=3, plen=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (plen,)).astype(np.int32) for _ in range(n)]


def _undisturbed(tm, prompts, budget):
    eng = BatchDecodeEngine(tm, device="cpu", max_slots=4, chunk=4,
                            page_size=16)
    reqs = [GenerationRequest(p, budget) for p in prompts]
    eng.serve(reqs, timeout=120)
    return [r.result.result(5) for r in reqs]


def _serving(tm, chunk_delay_s=0.0, **kw):
    """A port serving engine over ``tm``; ``chunk_delay_s`` stretches each
    decode chunk on the host, so a deadline lands mid-decode."""
    se = ServingEngine(tm, max_batch_size=4, kv_page_size=16,
                       decode_chunk=4, device="cpu", **kw)
    if chunk_delay_s:
        chunk = se.engine._decode_chunk

        def slow_chunk():
            time.sleep(chunk_delay_s)
            chunk()

        se.engine._decode_chunk = slow_chunk
    return se


def test_continuous_cancel_frees_slot_mid_decode(tm):
    prompts = _prompts(1)
    want = _undisturbed(tm, prompts, 24)
    with _serving(tm, chunk_delay_s=0.03) as se:
        eng = se.engine
        futs = [se.submit(p, max_new_tokens=24) for p in prompts]
        doomed = se.submit(_prompts(2, 1)[0], max_new_tokens=80)
        assert _await(lambda: eng.busy_slots() == 4
                      and eng.stats["decode_calls"] > 0, 30)
        assert doomed.cancel() is True
        with pytest.raises(trob.RequestCancelledError):
            doomed.result(5)
        outs = [f.result(60) for f in futs]
        assert _await(lambda: eng.busy_slots() == 0)
        assert se.stats["cancelled"] == 1
        assert eng.pool.free_count == eng.pool.usable
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)


def test_continuous_deadline_expires_mid_decode(tm):
    prompts = _prompts(3)
    want = _undisturbed(tm, prompts, 24)
    with _serving(tm, chunk_delay_s=0.03) as se:
        eng = se.engine
        futs = [se.submit(p, max_new_tokens=24) for p in prompts]
        doomed = se.submit(_prompts(4, 1)[0], max_new_tokens=80,
                           deadline_s=0.4)
        with pytest.raises(trob.DeadlineExceededError, match="mid-decode"):
            doomed.result(30)
        assert doomed.slo()["ttft_s"] is not None     # it was admitted
        outs = [f.result(60) for f in futs]
        assert _await(lambda: eng.busy_slots() == 0)
        assert se.stats["deadline_expired"] == 1
        assert eng.pool.free_count == eng.pool.usable
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)


def test_continuous_drain_finishes_inflight_and_refuses_new(tm):
    prompts = _prompts(5)
    want = _undisturbed(tm, prompts, 16)
    se = _serving(tm, drain_timeout_s=60.0)
    try:
        eng = se.engine
        futs = [se.submit(p, max_new_tokens=16) for p in prompts]
        assert _await(lambda: eng.busy_slots() == 3, 30)
        res = se.drain()
        assert res["clean"] and res["shed"] == 0
        for f, w in zip(futs, want):
            np.testing.assert_array_equal(f.result(0), w)
        with pytest.raises(trob.EngineDrainingError):
            se.submit(prompts[0], max_new_tokens=4)
        assert se.health()["state"] == "stopped"
        assert eng.pool.free_count == eng.pool.usable
        se.start()                                  # a new serving epoch
        np.testing.assert_array_equal(
            se.generate(prompts[0], max_new_tokens=16, timeout=60), want[0])
    finally:
        se.stop()


def test_continuous_health_and_watchdog_flags(tm):
    with _serving(tm, decode_timeout_s=30.0) as se:
        se.generate(_prompts(6, 1)[0], max_new_tokens=4, timeout=60)
        h = se.health()
        assert h["ok"] and h["mode"] == "continuous"
        assert h["kv"]["layout"] == "paged"
        assert h["pages_free"] == se.engine.pool.usable
        assert h["fused"]["enabled"] and h["spec"] == {"enabled": False}
        assert h["compile"]["programs_built"] == 1
        assert se._watchdog_thread is not None
        assert se._watchdog_thread.is_alive()
    assert se.decode_timeout_s == 30.0
