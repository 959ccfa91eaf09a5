"""The port's serving fleet (``inference/router.py``, ``inference/fleet.py``)
held against the JAX package's on the CPU.

Two kinds of case:

* Routing and control logic over STATIC fake-model engines (a
  ``generate_cached`` lookalike, as the reference's own fleet tests use),
  run once per package with the same steps and the same assertions:
  least-loaded picks, breaker eviction and half-open re-admission,
  mid-flight failover after ``kill()``, the typed whole-fleet refusal,
  prefix affinity, rolling restart, elastic membership, the autoscaler's
  ticks and the deploy pipeline's validation and promotion.
* End to end over a tiny f32 Llama (weights moved across with
  ``convert.py``): a router over two port replicas against the reference's
  router over two JAX replicas, the same prompts, greedy tokens equal; then
  failover after ``kill()``, one hedged request and a rolling restart under
  load, each in both packages and each equal to the reference's tokens.

No timing assertion: the slow replica in the failover and hedge cases is
one whose scheduler waits on an event, so which replica serves a request
does not depend on the host's speed. Every wait has its own limit.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.inference as jinf
from paddlepaddle_tpu.inference import fleet as jfleet
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddlepaddle_tpu.resilience.retry import RetryPolicy as JRetry
import paddlepaddle_tpu_torch.inference as tinf
from paddlepaddle_tpu_torch import convert
from paddlepaddle_tpu_torch.inference import fleet as tfleet
from paddlepaddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu_torch.resilience.retry import RetryPolicy as TRetry

_QUIET = 60.0     # the prober stays quiet; tests probe and tick by hand
WAIT = 120        # seconds any single future may take


def _ns(inf, fleet_mod, retry, name):
    return types.SimpleNamespace(name=name, inf=inf, fleet=fleet_mod,
                                 RetryPolicy=retry)


PACKAGES = {"jax": _ns(jinf, jfleet, JRetry, "jax"),
            "port": _ns(tinf, tfleet, TRetry, "port")}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class _Out:
    def __init__(self, a):
        self._a = a

    def numpy(self):
        return self._a


class FakeModel:
    """generate_cached lookalike: the prompt plus zeros, with injectable
    latency and failures."""

    def __init__(self, delay_s=0.0, fail_next=0):
        self.delay_s = delay_s
        self.fail_next = fail_next

    def generate_cached(self, ids, max_new_tokens, temperature=0.0, top_k=0,
                        eos_token_id=None):
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


def _factory(pkg, model=None, **kw):
    kw.setdefault("mode", "static")
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("max_len", 64)
    return lambda: pkg.inf.ServingEngine(
        model() if callable(model) else (model or FakeModel()), **kw)


def _resolve_all(futs, timeout=WAIT):
    oks, errs = [], []
    for f in futs:
        try:
            oks.append(f.result(timeout))
        except Exception as e:  # noqa: BLE001 — collected for assertions
            errs.append(e)
    return oks, errs


class _P:
    """The two fields ``_pick`` reads of a pending request."""

    def __init__(self, prefix_key=None):
        self.tried = set()
        self.prefix_key = prefix_key


# -- routing over fake engines, both packages --------------------------------

def test_pick_least_estimated_wait(pkg):
    r = pkg.inf.ServingRouter([_factory(pkg) for _ in range(3)],
                              probe_interval_s=_QUIET)
    r.start()
    try:
        r._probe_once()
        loaded, idle, mid = r._replicas
        loaded.snapshot = dict(loaded.snapshot, est_wait_s=2.0, ok=True)
        mid.snapshot = dict(mid.snapshot, est_wait_s=0.5, ok=True)
        idle.snapshot = dict(idle.snapshot, est_wait_s=0.0, ok=True)
        assert r._pick(_P()) is idle
        idle.inflight = 5
        idle.snapshot = dict(idle.snapshot, est_wait_s=0.5)
        assert r._pick(_P()) is mid
    finally:
        r.stop()


def test_traffic_spreads_and_accounts(pkg):
    r = pkg.inf.ServingRouter(
        [_factory(pkg, FakeModel(delay_s=0.01)),
         _factory(pkg, FakeModel(delay_s=0.01))], probe_interval_s=0.05)
    try:
        futs = [r.submit(_prompt(), max_new_tokens=2) for _ in range(16)]
        oks, errs = _resolve_all(futs)
        assert len(oks) == 16 and not errs
        h = r.health()
        assert h["router"]["submitted"] == 16
        assert h["router"]["completed"] == 16
        assert h["router"]["failed"] == 0
        assert h["router"]["picks"] == 16
        assert sum(rep.client.engine.stats["requests"]
                   for rep in r._replicas) == 16
        # the wrapper future carries the serving replica's SLO stamps
        assert all(f.slo()["latency_s"] is not None for f in futs)
    finally:
        r.stop()


def test_breaker_evicts_sick_replica_then_readmits(pkg):
    r = pkg.inf.ServingRouter(
        [_factory(pkg, FakeModel(fail_next=3), max_batch_size=1),
         _factory(pkg, FakeModel(), max_batch_size=1)],
        probe_interval_s=_QUIET, breaker_threshold=3, breaker_reset_s=30.0)
    r.start()
    try:
        r._probe_once()
        sick, healthy = r._replicas
        healthy.snapshot = dict(healthy.snapshot, est_wait_s=5.0)
        served = 0
        while sick.breaker.state != "open" and served < 10:
            assert r.submit(_prompt(), max_new_tokens=2).result(WAIT) \
                .shape == (6,)
            served += 1
        assert sick.breaker.state == "open"
        assert r.stats["evictions"] == 1 and r.stats["failovers"] >= 3
        healthy.snapshot = dict(healthy.snapshot, est_wait_s=0.0)
        before = sick.client.engine.stats["requests"]
        for _ in range(4):
            r.submit(_prompt(), max_new_tokens=2).result(WAIT)
        assert sick.client.engine.stats["requests"] == before
        sick.breaker._opened_at -= 31.0    # the reset window, rewound
        r._probe_once()
        assert sick.breaker.state == "closed"
        assert r.stats["readmissions"] == 1
    finally:
        r.stop()


def test_midflight_kill_fails_over_and_preserves_results(pkg):
    r = pkg.inf.ServingRouter(
        [_factory(pkg, FakeModel(delay_s=0.05), max_batch_size=1),
         _factory(pkg, FakeModel(delay_s=0.05), max_batch_size=1)],
        probe_interval_s=0.05, breaker_reset_s=0.3)
    try:
        futs = [r.submit(_prompt(n=4, v=i), max_new_tokens=2)
                for i in range(8)]
        r._replicas[0].client.kill()
        oks, errs = _resolve_all(futs)
        assert not errs, [type(e).__name__ for e in errs]
        for i, out in enumerate(oks):
            assert out.shape == (6,) and (out[:4] == i).all()
        assert r.health()["router"]["completed"] == 8
    finally:
        r.stop()


def test_all_replicas_out_is_typed_fleet_unavailable(pkg):
    r = pkg.inf.ServingRouter([_factory(pkg)], probe_interval_s=_QUIET,
                              breaker_reset_s=5.0)
    r.start()
    try:
        r._replicas[0].client.kill()
        for _ in range(3):
            r._probe_once()
        with pytest.raises(pkg.inf.FleetUnavailableError) as ei:
            r.submit(_prompt(), max_new_tokens=2)
        assert ei.value.replicas == 1 and ei.value.retry_after_s > 0
    finally:
        r.stop()


def test_validation_and_deadline_refusals_are_not_retried(pkg):
    r = pkg.inf.ServingRouter([_factory(pkg, max_len=16),
                               _factory(pkg, max_len=16)],
                              probe_interval_s=_QUIET)
    try:
        with pytest.raises(pkg.inf.RequestValidationError):
            r.submit(_prompt(14), max_new_tokens=8)
        with pytest.raises(pkg.inf.DeadlineExceededError):
            r.submit(_prompt(), max_new_tokens=2, deadline_s=0.0)
        assert r.stats["retries"] == 0 and r.stats["failovers"] == 0
    finally:
        r.stop()


def test_prefix_affinity_is_the_reference_rendezvous(pkg):
    """The same prefixes land on the same replica names in both packages
    (rendezvous hashing over sha1), and a replica out of rotation moves
    only its own keys."""
    r = pkg.inf.ServingRouter([_factory(pkg) for _ in range(4)],
                              probe_interval_s=_QUIET)
    r.start()
    try:
        r._probe_once()
        rng = np.random.default_rng(0)
        prefixes = [rng.integers(0, 1000, (16,)).astype(np.int32).tobytes()
                    for _ in range(12)]
        homes = [r._pick(_P(p)).name for p in prefixes]
        assert homes == _rendezvous_homes(prefixes)
        out = next(rep for rep in r._replicas if rep.name == homes[0])
        out.in_rotation = False
        moved = [r._pick(_P(p)).name for p in prefixes]
        assert all(m == h for m, h in zip(moved, homes) if h != out.name)
        assert out.name not in moved
    finally:
        r.stop()


def _rendezvous_homes(prefixes):
    import hashlib

    names = [f"r{i}" for i in range(4)]
    return [max(names, key=lambda n: hashlib.sha1(p + n.encode()).digest())
            for p in prefixes]


def test_drain_refuses_then_sheds_typed(pkg):
    r = pkg.inf.ServingRouter([_factory(pkg), _factory(pkg)],
                              probe_interval_s=_QUIET)
    try:
        assert r.generate(_prompt(), max_new_tokens=2,
                          timeout=WAIT).shape == (6,)
        res = r.drain(timeout=5)
        assert res["clean"]
        with pytest.raises(pkg.inf.EngineDrainingError):
            r.submit(_prompt(), max_new_tokens=2)
        assert r.health()["state"] in ("draining", "stopped")
    finally:
        r.stop()


def test_rolling_restart_builds_fresh_engines_and_drops_nothing(pkg):
    r = pkg.inf.ServingRouter(
        [_factory(pkg, FakeModel(delay_s=0.005)),
         _factory(pkg, FakeModel(delay_s=0.005))], probe_interval_s=0.05)
    try:
        futs, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                try:
                    futs.append(r.submit(_prompt(), max_new_tokens=2))
                except pkg.inf.ServingError:
                    pass
                time.sleep(0.002)

        t = threading.Thread(target=client)
        t.start()
        engines = [rep.client.engine for rep in r._replicas]
        res = r.rolling_restart(drain_timeout=10, health_timeout=30)
        stop.set()
        t.join(WAIT)
        assert res["ok"], res
        assert [x["generation"] for x in res["replicas"]] == [1, 1]
        assert all(rep.client.engine is not e
                   for rep, e in zip(r._replicas, engines))
        oks, errs = _resolve_all(futs)
        assert futs and not errs, [type(e).__name__ for e in errs]
        assert r.stats["rolling_restarts"] == 1
    finally:
        r.stop()


def test_add_and_remove_replica_under_the_reference_rules(pkg):
    r = pkg.inf.ServingRouter([_factory(pkg), _factory(pkg)],
                              probe_interval_s=_QUIET)
    r.start()
    try:
        name = r.add_replica(_factory(pkg))
        assert name == "r2" and len(r._replicas) == 3
        r._probe_once()
        assert r.generate(_prompt(), max_new_tokens=2,
                          timeout=WAIT).shape == (6,)
        res = r.remove_replica("r0", drain_timeout=5)
        assert res["replica"] == "r0" and res["clean"]
        assert [rep.name for rep in r._replicas] == ["r1", "r2"]
        assert r.stats["evictions"] == 0
        r.remove_replica("r1", drain_timeout=5)
        with pytest.raises(ValueError):
            r.remove_replica("r2")
    finally:
        r.stop()


# -- the fleet controller over fake engines, both packages -------------------

def _policy(pkg, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("up_streak", 2)
    kw.setdefault("down_streak", 3)
    kw.setdefault("cooldown_up_s", 0.0)
    kw.setdefault("cooldown_down_s", 0.0)
    kw.setdefault("health_timeout_s", 5.0)
    kw.setdefault("drain_timeout_s", 2.0)
    return pkg.inf.FleetPolicy(**kw)


def _fleet(pkg, n=1, policy=None, model_fn=None, **kw):
    def factory(version):
        model = model_fn(version) if model_fn is not None else FakeModel()
        return pkg.inf.ServingEngine(model, mode="static", max_batch_size=4,
                                     max_wait_ms=2.0, max_len=64)

    fc = pkg.inf.FleetController(factory, initial_replicas=n,
                                 policy=policy or _policy(pkg),
                                 probe_interval_s=_QUIET, **kw)
    fc.start(autoscaler=False)
    fc.router._probe_once()
    return fc


def _force_signal(fc, est_wait, queue_depth=0):
    for rep in fc.router._replicas:
        rep.snapshot = dict(rep.snapshot or {}, ok=True,
                            est_wait_s=est_wait, queue_depth=queue_depth)


def test_autoscaler_ticks_scale_up_then_down(pkg):
    fc = _fleet(pkg, 1, policy=_policy(pkg, max_replicas=2, up_streak=2,
                                       down_streak=2))
    try:
        _force_signal(fc, est_wait=5.0)
        assert fc._tick()["action"] is None
        assert fc._tick()["action"] == "up"
        assert len(fc.router._replicas) == 2
        _force_signal(fc, est_wait=5.0)
        for _ in range(3):
            assert fc._tick()["action"] is None     # max_replicas
        fc.router._probe_once()
        assert fc.generate(_prompt(), max_new_tokens=2,
                           timeout=WAIT).shape == (6,)
        _force_signal(fc, est_wait=0.0)
        assert fc._tick()["action"] is None
        assert fc._tick()["action"] == "down"
        assert len(fc.router._replicas) == 1
        assert fc.stats["scale_ups"] == 1 and fc.stats["scale_downs"] == 1
        assert fc.router.stats["evictions"] == 0
    finally:
        fc.stop()


def _bundle(pkg, tmp, name, corrupt=False):
    """A candidate bundle of each package's format with no payload (the
    deploy pipeline validates the manifest and the payload hashes; the
    fake engines load nothing). ``corrupt`` adds a payload whose sha256
    does not match."""
    bp = os.path.join(str(tmp), pkg.name, name)
    os.makedirs(bp, exist_ok=True)
    manifest = {"format_version": 1, "created_unix": time.time(),
                "version": f"{name}-vid", "fingerprint": "f" * 64}
    if corrupt:
        with open(os.path.join(bp, "payload.bin"), "wb") as f:
            f.write(b"junk")
        row = {"file": "payload.bin", "bytes": 4, "sha256": "0" * 64}
        if pkg.name == "jax":
            manifest["entries"] = [dict(row, key="decode")]
        else:
            manifest["libraries"] = [dict(row, name="paged_attention")]
    with open(os.path.join(bp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return bp


def test_deploy_rejects_bad_bundles_before_touching_the_fleet(pkg,
                                                              tmp_path):
    fc = _fleet(pkg, 2)
    try:
        gens = [rep.client.generation for rep in fc.router._replicas]
        for bad in (os.path.join(str(tmp_path), "missing"),
                    _bundle(pkg, tmp_path, "bad", corrupt=True)):
            with pytest.raises(pkg.inf.DeployError) as ei:
                fc.deploy(bad)
            assert ei.value.stage == "validate" and ei.value.reasons
        assert [rep.client.generation
                for rep in fc.router._replicas] == gens
    finally:
        fc.stop()


def test_deploy_promotes_then_a_gate_veto_rolls_back(pkg, tmp_path):
    fc = _fleet(pkg, 2)
    try:
        v2 = _bundle(pkg, tmp_path, "v2")
        res = fc.deploy(v2, canary_requests=2, canary_new_tokens=2)
        assert res["ok"] and res["stage"] == "done", res
        assert res["manifest_version"] == "v2-vid"
        assert set(fc._versions.values()) == {v2}
        v3 = _bundle(pkg, tmp_path, "v3")
        res = fc.deploy(v3, canary_requests=2, canary_new_tokens=2,
                        gate=lambda _m: ["vetoed by the test"])
        assert not res["ok"] and res["stage"] == "canary", res
        assert res["reasons"] == ["vetoed by the test"]
        assert fc.rollout["state"] == "rolled_back"
        assert set(fc._versions.values()) == {v2} and fc.version == v2
        assert fc.stats["rollouts"] == 1 and fc.stats["rollbacks"] == 1
    finally:
        fc.stop()


def test_failover_resubmits_off_the_failing_replicas_thread():
    """Port: a failed request is resubmitted from the router's retry
    thread, never from the failing engine's scheduler thread (which runs
    the future's callbacks): a remote replica's submit blocks on the wire
    and would stall that engine's loop."""
    seen = []

    class Recording(tinf.ReplicaClient):
        def submit(self, prompt_ids, **kw):
            seen.append(threading.current_thread().name)
            return super().submit(prompt_ids, **kw)

    sick = Recording(_factory(PACKAGES["port"], FakeModel(fail_next=1),
                              max_batch_size=1), name="r0")
    well = Recording(_factory(PACKAGES["port"], max_batch_size=1),
                     name="r1")
    r = tinf.ServingRouter([sick, well], probe_interval_s=_QUIET)
    try:
        assert r.generate(_prompt(), max_new_tokens=2,
                          timeout=WAIT).shape == (6,)
        assert r.stats["failovers"] == 1
        assert seen == [threading.main_thread().name, "router-retrier"]
    finally:
        r.stop()


# -- end to end over a tiny Llama: the port's router against the reference's --

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=96, dtype="float32")
SERVE = dict(max_batch_size=3, decode_chunk=4, kv_page_size=16, max_len=96)
BUDGET = 8


def _llama_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, (n,)).astype(np.int32)
            for n in (5, 17, 3, 40, 11, 26)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    convert.load_jax_state(
        tm, {k: np.asarray(v) for k, v in jm.functional_state().items()})
    return {"jax": jm, "port": tm}


def _engine_factory(pkg, models, gate=None):
    def make():
        if pkg.name == "jax":
            se = pkg.inf.ServingEngine(models["jax"], **SERVE)
        else:
            se = pkg.inf.ServingEngine(models["port"], device="cpu", **SERVE)
        if gate is not None:
            _hold(se, gate)
        return se

    return make


def _hold(se, gate):
    """Keep ``se``'s scheduler from taking work until ``gate`` is set (or
    the engine stops): the replica is alive and reads healthy, but serves
    nothing meanwhile."""
    run = se._loop_continuous

    def held():
        while not gate.is_set():
            if se._stop.wait(0.01):
                return
        run()

    se._loop_continuous = held


@pytest.fixture(scope="module")
def want(models):
    """The reference's router over two JAX replicas: the tokens every
    port case must give."""
    pkg = PACKAGES["jax"]
    r = pkg.inf.ServingRouter([_engine_factory(pkg, models),
                               _engine_factory(pkg, models)],
                              probe_interval_s=0.05, hedge_after_s=None)
    try:
        futs = [r.submit(p, max_new_tokens=BUDGET) for p in _llama_prompts()]
        out = [np.asarray(f.result(WAIT)) for f in futs]
        assert r.health()["router"]["completed"] == len(out)
        return out
    finally:
        r.stop()


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_port_router_tokens_equal_the_reference_router(models, want):
    pkg = PACKAGES["port"]
    r = pkg.inf.ServingRouter([_engine_factory(pkg, models),
                               _engine_factory(pkg, models)],
                              probe_interval_s=0.05, hedge_after_s=None)
    try:
        futs = [r.submit(p, max_new_tokens=BUDGET) for p in _llama_prompts()]
        _check([f.result(WAIT) for f in futs], want)
        h = r.health()
        assert h["ok"] and h["router"]["completed"] == len(futs)
        assert all(rep.client.engine.stats["requests"] > 0
                   for rep in r._replicas)
    finally:
        r.stop()


def test_failover_after_kill_gives_the_reference_tokens(pkg, models, want):
    """Replica r0 holds its queue (its scheduler waits), so the first pick
    is queued there when it is killed; every request completes on r1."""
    gate = threading.Event()
    r = pkg.inf.ServingRouter([_engine_factory(pkg, models, gate),
                               _engine_factory(pkg, models)],
                              probe_interval_s=_QUIET, hedge_after_s=None)
    try:
        r.start()
        futs = [r.submit(p, max_new_tokens=BUDGET) for p in _llama_prompts()]
        r._replicas[0].client.kill()
        _check([f.result(WAIT) for f in futs], want)
        assert r.stats["failovers"] >= 1
        assert r.health()["router"]["failed"] == 0
    finally:
        gate.set()
        r.stop()


def test_hedged_request_gives_the_reference_tokens(pkg, models, want):
    """The first pick (r0) holds its queue; after ``hedge_after_s`` the
    router sends one duplicate to r1, which wins; the loser is
    cancelled."""
    gate = threading.Event()
    r = pkg.inf.ServingRouter([_engine_factory(pkg, models, gate),
                               _engine_factory(pkg, models)],
                              probe_interval_s=_QUIET, hedge_after_s=0.05,
                              hedge_budget_pct=100.0)
    try:
        r.start()
        fut = r.submit(_llama_prompts()[0], max_new_tokens=BUDGET)
        _check([fut.result(WAIT)], want[:1])
        assert r.stats["hedges"] == 1 and r.stats["hedge_wins"] == 1
        assert r.health()["router"]["completed"] == 1
    finally:
        gate.set()
        r.stop()


def test_rolling_restart_under_load_gives_the_reference_tokens(pkg, models,
                                                               want):
    r = pkg.inf.ServingRouter([_engine_factory(pkg, models),
                               _engine_factory(pkg, models)],
                              probe_interval_s=0.05, hedge_after_s=None)
    try:
        prompts = _llama_prompts()
        futs = [r.submit(p, max_new_tokens=BUDGET) for p in prompts]
        res = r.rolling_restart(drain_timeout=WAIT, health_timeout=WAIT)
        more = [r.submit(p, max_new_tokens=BUDGET) for p in prompts]
        _check([f.result(WAIT) for f in futs + more], want + want)
        assert res["ok"], res
        assert r.health()["router"]["failed"] == 0
        assert all(x["warmup"] is not None for x in res["replicas"])
    finally:
        r.stop()
