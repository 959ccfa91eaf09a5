"""Elastic membership (``paddlepaddle_tpu_torch/distributed/fleet/elastic``)
and the launcher's ``--nnodes lo:hi`` on the CPU, against the JAX package.

* The five manager tests of the JAX package's ``tests/test_elastic.py``
  :23-113 over the port's ``TCPStore``: scale up, scale down on a dead
  heartbeat, the ``min_np`` floor, ``wait_for_np`` and the ``max_np`` cap
  with no re-commit of an unchanged capped world.
* ``launch --nnodes 1:2``: two launchers (node 1 dials node 0's store)
  train ``tests/torch_elastic_job.py``'s job in a world of 2 (version 1);
  node 1's launcher and worker are killed (SIGKILL to its process group),
  node 0's launcher relaunches its worker into a world of 1 (version 2),
  which resumes from the newest checkpoint (``CheckpointManager``); node 1
  comes back and both are relaunched into a world of 2 (version 3). Two
  scale events, no more; every incarnation's rows are the sampler
  oracle's; the losses of the six steps equal one uninterrupted process's
  to 1e-6 (f32) and the JAX package's one-process run of the same schedule
  to 1e-5.
* The kill-resume drill of the JAX package's ``tests/test_elastic.py:189``
  through the port's ``save`` / ``load``: its final loss equals an
  uninterrupted one-worker run's (1e-6) and the JAX package's one-process
  run's (1e-5).

No fixed ports (free ones are taken), timeouts with margin, and scale
events counted from the launcher's log instead of slept for.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                              ElasticNode)
from paddlepaddle_tpu_torch.distributed.store import TCPStore

import torch_elastic_job as J

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = os.path.join(ROOT, "tests", "torch_elastic_job.py")


def _store():
    return TCPStore(is_master=True)


# -- the manager (JAX package tests/test_elastic.py:23-113) ------------------

def test_scale_up_commits_new_world():
    store = _store()
    mgr = ElasticManager(store, np_range=(1, 4), heartbeat_timeout=1.0)
    n0 = ElasticNode(store, "hostA", heartbeat_interval=0.1)
    n0.register()
    mgr.scan_once()
    assert mgr.version == 1 and mgr.members == ["hostA"]
    n1 = ElasticNode(store, "hostB", heartbeat_interval=0.1)
    n1.register()
    mgr.scan_once()
    assert mgr.version == 2 and mgr.members == ["hostA", "hostB"]
    version, members = ElasticManager.read_world(store)
    assert version == 2 and members == ["hostA", "hostB"]
    assert n0.world_changed(1) and not n0.world_changed(2)
    n0.stop()
    n1.stop()


def test_scale_down_on_dead_heartbeat():
    store = _store()
    mgr = ElasticManager(store, np_range=(1, 4), heartbeat_timeout=0.4)
    n0 = ElasticNode(store, "hostA", heartbeat_interval=0.1)
    n1 = ElasticNode(store, "hostB", heartbeat_interval=0.1)
    n0.register()
    n1.register()
    mgr.scan_once()
    assert sorted(mgr.members) == ["hostA", "hostB"]
    n1.stop()
    deadline = time.time() + 20
    while time.time() < deadline and "hostB" in mgr.members:
        time.sleep(0.1)
        mgr.scan_once()
    assert mgr.members == ["hostA"]
    version, members = ElasticManager.read_world(store)
    assert members == ["hostA"] and version >= 2
    n0.stop()


def test_min_np_floor_blocks_undersized_world():
    store = _store()
    mgr = ElasticManager(store, np_range=(2, 4), heartbeat_timeout=0.3)
    n0 = ElasticNode(store, "hostA", heartbeat_interval=0.1)
    n1 = ElasticNode(store, "hostB", heartbeat_interval=0.1)
    n0.register()
    n1.register()
    mgr.scan_once()
    assert len(mgr.members) == 2
    n1.stop()
    time.sleep(0.8)
    mgr.scan_once()
    assert sorted(mgr.members) == ["hostA", "hostB"]
    n0.stop()


def test_wait_for_np_rendezvous():
    store = _store()
    mgr = ElasticManager(store, np_range=(2, 4), heartbeat_timeout=1.0)
    n0 = ElasticNode(store, "hostA", heartbeat_interval=0.1)
    n0.register()
    with pytest.raises(TimeoutError):
        mgr.wait_for_np(2, timeout=0.5)
    n1 = ElasticNode(store, "hostB", heartbeat_interval=0.1)
    n1.register()
    version, members = mgr.wait_for_np(2, timeout=20)
    assert version >= 1 and sorted(members) == ["hostA", "hostB"]
    n0.stop()
    n1.stop()


def test_max_np_caps_world():
    store = _store()
    mgr = ElasticManager(store, np_range=(1, 2), heartbeat_timeout=1.0)
    nodes = [ElasticNode(store, f"h{i}", heartbeat_interval=0.1)
             for i in range(3)]
    for n in nodes:
        n.register()
    mgr.scan_once()
    assert len(mgr.members) == 2
    v = mgr.version
    for _ in range(5):
        mgr.scan_once()
    assert mgr.version == v
    for n in nodes:
        n.stop()


# -- launch --nnodes 1:2: 2 -> 1 -> 2 ----------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launcher(node_rank, port, env, log):
    cmd = [sys.executable, "-m", "paddlepaddle_tpu_torch.distributed.launch",
           "--nnodes", "1:2", "--nproc_per_node", "1",
           "--node_rank", str(node_rank), "--master", f"127.0.0.1:{port}",
           JOB, "elastic"]
    # its own session: SIGKILL to the group takes the node's launcher and
    # its worker together, as a lost host would
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _wait_for(paths, procs, timeout, logs):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(os.path.exists(p) for p in paths):
            time.sleep(0.2)   # the writer closes the file
            return [json.load(open(p)) for p in paths]
        for p in procs:
            if p.poll() not in (None, 0):
                break
        time.sleep(0.2)
    tails = {k: open(v).read()[-3000:] for k, v in logs.items()}
    raise AssertionError(f"missing {paths}: {tails}")


def _kill_group(p):
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait(timeout=30)


def _jax_losses(steps):
    """The JAX package's one-process run of the job's schedule."""
    x, y = J.data()
    w, b = J.init_weights()
    lin = paddle.nn.Linear(4, 1)
    lin.weight.set_value(paddle.to_tensor(w))
    lin.bias.set_value(paddle.to_tensor(b))
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=lin.parameters())
    losses = []
    for rows in J.global_batches()[:steps]:
        xb, yb = paddle.to_tensor(x[rows]), paddle.to_tensor(y[rows])
        loss = ((lin(xb) - yb) ** 2).sum() / J.GLOBAL_BATCH
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def test_launch_elastic_scale_down_and_back_up_resumes(tmp_path):
    port = _free_port()
    env = dict(os.environ, JOB_DIR=str(tmp_path), JOB_TOTAL="6",
               JOB_STOPS="2,4")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "MASTER_ADDR",
              "MASTER_PORT", "PADDLE_WORLD_VERSION", "PADDLE_OBS_EXPORT"):
        env.pop(k, None)
    logs = {n: str(tmp_path / f"{n}.log") for n in ("node0", "node1",
                                                      "node1b")}
    f = {n: open(p, "w") for n, p in logs.items()}
    procs = []
    try:
        node1 = _launcher(1, port, env, f["node1"])
        node0 = _launcher(0, port, env, f["node0"])
        procs += [node1, node0]
        v1 = _wait_for([str(tmp_path / f"v1.rank{r}.json") for r in (0, 1)],
                       procs, 180, logs)
        _kill_group(node1)
        (v2,) = _wait_for([str(tmp_path / "v2.rank0.json")], [node0], 180,
                          logs)
        node1b = _launcher(1, port, env, f["node1b"])
        procs.append(node1b)
        v3 = _wait_for([str(tmp_path / f"v3.rank{r}.json") for r in (0, 1)],
                       [node0, node1b], 180, logs)
        assert node0.wait(timeout=120) == 0
        assert node1b.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                _kill_group(p)
        for h in f.values():
            h.close()
    log0 = open(logs["node0"]).read()
    assert log0.count("elastic scale event") == 2, log0[-3000:]
    assert "elastic scale event v2: 1 nodes" in log0
    assert "elastic scale event v3: 2 nodes" in log0
    assert [(r["version"], r["world"], r["start"], r["end"]) for r in v1] == \
        [(1, 2, 0, 2)] * 2
    assert (v2["version"], v2["world"], v2["start"], v2["end"]) == \
        (2, 1, 2, 4)
    assert [(r["version"], r["world"], r["start"], r["end"]) for r in v3] == \
        [(3, 2, 4, 6)] * 2
    # the ranks of a world report the same (all-reduced) losses
    assert v1[0]["losses"] == v1[1]["losses"]
    assert v3[0]["losses"] == v3[1]["losses"]
    # every incarnation's rows are the sampler oracle's
    x, _ = J.data()
    batches = J.global_batches()
    for rec in v1 + [v2] + v3:
        w, r = rec["world"], rec["rank"]
        for k, rows in zip(range(rec["start"], rec["end"]), rec["rows"]):
            np.testing.assert_array_equal(
                np.asarray(rows, np.float32), x[batches[k][r::w]])
    resumed = v1[0]["losses"] + v2["losses"] + v3[0]["losses"]
    np.testing.assert_allclose(resumed, J.uninterrupted(), rtol=1e-6)
    np.testing.assert_allclose(resumed, _jax_losses(6), rtol=1e-5)
    assert len(glob.glob(str(tmp_path / "ckpt" / "step-*"))) <= 2


# -- the kill-resume drill (JAX package tests/test_elastic.py:189) -----------

def test_kill_resume_drill_matches_uninterrupted(tmp_path):
    def run(world, tag, with_kill):
        d = tmp_path / tag
        d.mkdir()
        env = dict(os.environ, DRILL_CKPT=str(d / "ckpt.pd"),
                   DRILL_MARKER=str(d / "marker"),
                   DRILL_OUT=str(d / "final_loss.txt"))
        for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                  "PADDLE_WORLD_VERSION"):
            env.pop(k, None)
        cmd = [sys.executable, "-m",
               "paddlepaddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(world), "--max_restarts", "1", JOB,
               "drill"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, env=env, cwd=ROOT)
        assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
        if with_kill:
            assert (d / "marker").exists(), "the kill never fired"
            assert "restart 1/1" in out.stderr
        return float((d / "final_loss.txt").read_text())

    interrupted = run(2, "duo_kill", with_kill=True)
    baseline = run(1, "solo", with_kill=False)
    np.testing.assert_allclose(interrupted, baseline, rtol=1e-6)
    # the JAX package's one process, the same schedule
    x, _ = J.data()
    x = x[:16]
    y = x @ np.asarray([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    w, b = J.init_weights()
    lin = paddle.nn.Linear(4, 1)
    lin.weight.set_value(paddle.to_tensor(w))
    lin.bias.set_value(paddle.to_tensor(b))
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=lin.parameters())
    for _ in range(10):
        loss = ((lin(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(interrupted, float(loss.numpy()), rtol=1e-5)
