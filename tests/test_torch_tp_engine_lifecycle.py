"""Lifecycle of the single-process tensor-parallel engine on the CPU: its
worker ranks end with it, and it serves behind the router and as a
replica process.

* The workers' pids are gone within 15 s after ``stop()``, after the engine
  is collected without one, after the driver process is SIGKILLed
  mid-serve, and after a replica process is SIGTERMed (it drains) or
  SIGKILLed; a SIGKILLed worker
  fails rank 0's next request within 10 s (not at the process-group
  timeout), and every later one at once.
* The router drill of the reference (``tests/test_shard_plan.py:352-399``)
  on the port: two ``mesh="mp2"`` factories behind ``ServingRouter`` (four
  processes, two sets of groups), a ``serving.decode`` fault storm: no
  future lost, at least 6 of 8 served; a rolling restart (each engine's
  workers stopped, new ones started); then both replicas healthy.
* ``replica_main --engine-json '{"mesh": "mp2"}' --device cpu`` behind a
  ``RemoteReplicaClient`` serves the one-process engine's tokens, and its
  health reports tp 2 and the counters of both ranks.

This process runs with 2 CPU threads (the workers take rank 0's count),
restored at the end.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_dist_workers as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = dict(max_batch_size=2, decode_chunk=4, kv_page_size=16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _model(dtype="float32"):
    import paddlepaddle_tpu_torch as pt

    return pt.LlamaForCausalLM(pt.LlamaConfig(**dict(W.TINY, dtype=dtype)),
                               device="cpu", seed=0)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie (exited, not yet reaped by its parent) holds no resources
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _gone(pids, timeout=15.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.1)
    return False


def _one_tokens(model, prompts, n):
    import paddlepaddle_tpu_torch as pt

    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               device="cpu")
    reqs = W._requests(prompts, n)
    eng.serve(reqs)
    return [np.asarray(r.result.result(5)) for r in reqs]


PROMPT = np.arange(8, dtype=np.int32)


def test_workers_end_on_stop_and_when_the_engine_is_collected():
    import gc

    import paddlepaddle_tpu_torch as pt

    model = _model()
    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               mesh="mp2", device="cpu")
    pids = eng._tp.pids
    assert all(_alive(p) for p in pids)
    eng.stop()
    assert _gone(pids) and [p.exitcode for p in eng._tp.procs] == [0]
    eng.stop()                                   # idempotent
    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               mesh="mp2", device="cpu")
    reqs = W._requests([PROMPT], 3)
    eng.serve(reqs)
    pids = eng._tp.pids
    del eng, reqs
    gc.collect()
    assert _gone(pids)


def test_a_killed_worker_fails_the_next_request_within_ten_seconds():
    import paddlepaddle_tpu_torch as pt

    srv = pt.ServingEngine(_model(), mesh="mp2", device="cpu", **SERVE)
    try:
        srv.start()
        srv.generate(PROMPT, max_new_tokens=4, timeout=60)
        (pid,) = srv.health()["mesh"]["worker_pids"]
        os.kill(pid, signal.SIGKILL)
        assert _gone([pid])
        for _ in range(2):
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="rank"):
                srv.generate(PROMPT, max_new_tokens=4, timeout=60)
            assert time.monotonic() - t0 < 10.0
    finally:
        srv.stop()


_DRIVER = r"""
import json, sys, threading
import numpy as np
import paddlepaddle_tpu_torch as pt
cfg = pt.LlamaConfig(**json.loads(sys.argv[1]))
srv = pt.ServingEngine(pt.LlamaForCausalLM(cfg, device="cpu", seed=0),
                       max_batch_size=2, decode_chunk=4, kv_page_size=16,
                       mesh="mp2", device="cpu")
srv.start()
print(json.dumps(srv.health()["mesh"]["worker_pids"]), flush=True)
while True:
    srv.generate(np.arange(8, dtype=np.int32), max_new_tokens=40,
                 timeout=60)
    print("served", flush=True)
"""


def test_a_sigkilled_driver_takes_its_worker_with_it():
    """The driver (rank 0) SIGKILLed while it serves: its worker sees the
    parent gone and exits."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRIVER, json.dumps(W.TINY)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        pids = json.loads(proc.stdout.readline())
        assert proc.stdout.readline().strip() == "served"
        assert all(_alive(p) for p in pids)
        proc.kill()
        proc.wait(10)
        assert _gone(pids), pids
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_router_drill_over_two_mp2_engines():
    """The reference's chaos drill (``tests/test_shard_plan.py:352-399``):
    every future resolves under a ``serving.decode`` storm, at least 6 of
    8 served, a rolling restart replaces both engines' workers, and both
    replicas come back healthy."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.inference.router import ServingRouter
    from paddlepaddle_tpu_torch.resilience import chaos

    model = _model("bfloat16")
    made = []

    def factory():
        srv = pt.ServingEngine(model, mesh="mp2", device="cpu", **SERVE)
        made.append(srv)
        return srv

    r = ServingRouter([factory, factory], probe_interval_s=0.1,
                      breaker_threshold=3, breaker_reset_s=0.3)
    r.start()
    try:
        rng = np.random.default_rng(11)
        r.submit(rng.integers(0, 128, (8,)).astype(np.int32),
                 max_new_tokens=2).result(120)
        chaos.configure("serving.decode:exc:x2", seed=1234)
        futs = [r.submit(rng.integers(0, 128, (int(rng.integers(6, 20)),)
                                      ).astype(np.int32), max_new_tokens=3)
                for _ in range(8)]
        oks, errs = 0, []
        for f in futs:
            try:
                f.result(120)
                oks += 1
            except Exception as e:  # noqa: BLE001 — collected
                errs.append(e)
        assert oks + len(errs) == 8
        assert oks >= 6, f"only {oks}/8 completed: {errs}"
        old = [p for s in made for p in s.health()["mesh"]["worker_pids"]]
        rr = r.rolling_restart()
        assert rr["ok"] is True and len(rr["replicas"]) == 2
        assert len(made) == 4 and _gone(old)
        out = r.submit(rng.integers(0, 128, (8,)).astype(np.int32),
                       max_new_tokens=2).result(120)
        assert out.shape[0] == 10
        assert r.health()["router"]["healthy"] == 2
    finally:
        chaos.disable()
        r.stop()
    assert _gone([p.pid for s in made for p in s._engine._tp.procs])


def test_mp2_replica_process_serves_and_reports_every_rank():
    """``replica_main --engine-json '{"mesh": "mp2"}'``: one replica
    process and its worker serve the one-process engine's tokens; health
    reports tp 2 and a counter entry for each rank; SIGTERMed, it drains
    and joins its worker; SIGKILLed, it takes its worker with it."""
    from paddlepaddle_tpu_torch.inference.remote_replica import (
        RemoteReplicaClient, ReplicaSupervisor)

    prompts = [PROMPT, np.arange(3, 20, dtype=np.int32)]
    want = _one_tokens(_model(), prompts, 5)
    sup = ReplicaSupervisor(preset="tiny", name="tp2", warmup="off",
                            engine_json=json.dumps({"mesh": "mp2"}),
                            ready_timeout_s=240.0,
                            extra_args=["--device", "cpu"],
                            env=dict(os.environ, OMP_NUM_THREADS="2"))
    sup.start()
    try:
        cli = RemoteReplicaClient(address=sup.address(), name="tp2",
                                  read_timeout_s=120.0)
        cli.start()
        got = [cli.submit(p, max_new_tokens=5).result(120) for p in prompts]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        h = cli.health()
        assert h["mesh"]["tp"] == 2 and h["mesh"]["backend"] == "gloo"
        ranks = h["kernels"]["ranks"]
        assert [r["pid"] for r in ranks] == [sup.pid()] + \
            h["mesh"]["worker_pids"]
        assert all(r["decode_steps"] == ranks[0]["decode_steps"] > 0
                   and r["nvcc_runs"] == 0 for r in ranks)
        workers, first = h["mesh"]["worker_pids"], sup._proc
        sup.restart(drain_timeout=5.0)     # SIGTERM: drain, stop, exit 143
        assert first.wait(30) == 143 and _gone(workers), workers
        workers = cli.health()["mesh"]["worker_pids"]
        assert workers and all(_alive(p) for p in workers)
        sup.kill()
        assert _gone(workers), workers
    finally:
        sup.stop(drain_timeout=5.0)
