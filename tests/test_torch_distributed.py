"""The port's collective layer, store and launcher on the CPU
(``paddlepaddle_tpu_torch/distributed``): two gloo ranks started by the
port's own ``spawn``, and the launcher as a subprocess.

* eager collectives against numpy (sum, max, avg, gather, broadcast,
  reduce-scatter, all-to-all, scatter, objects, P2P, a batch of P2P ops,
  a bf16 sum and gather, native under gloo);
* the ``f_*`` functional collectives' gradients (the reference's: psum's
  transpose) against central finite differences in f64 at 1e-6;
* Megatron's layers (a column- then row-parallel MLP, the vocab-parallel
  embedding, the vocab-parallel cross entropy) against one rank's plain
  computation over the gathered weights, at 1e-5 (f32) / 1e-10 (f64);
* mesh groups, host collectives over the store and ``DataParallel``;
* ``TCPStore`` and the launcher, mirroring the reference's
  ``tests/test_store_launch_profiler.py:14-120``.

The rank bodies live in ``tests/torch_dist_workers.py``, which imports no
JAX. One spawn runs every collective case, and a module fixture shares its
result among the tests.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from paddlepaddle_tpu_torch.distributed import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def coll():
    return spawn(W.collectives_session, nprocs=2, timeout=240,
                 pg_timeout=60)


def _base(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank


def test_eager_collectives_against_numpy(coll):
    b0, b1 = _base(0), _base(1)
    for r in coll:
        np.testing.assert_array_equal(r["all_reduce"], b0 + b1)
        np.testing.assert_array_equal(r["all_reduce_max"], np.maximum(b0, b1))
        np.testing.assert_allclose(r["all_reduce_avg"], (b0 + b1) / 2)
        np.testing.assert_array_equal(np.stack(r["all_gather"]),
                                      np.stack([b0, b1]))
        np.testing.assert_array_equal(r["broadcast"], b1)
        assert r["objects"] == [{"r": 0}, {"r": 1}]
        assert r["world"] == 2
    # reduce_scatter: rank r keeps row r of the sum; all_to_all: rank r
    # gets row r of every rank's input
    for r, rank in zip(coll, (0, 1)):
        np.testing.assert_array_equal(r["reduce_scatter"], (b0 + b1)[rank])
        np.testing.assert_array_equal(np.stack(r["all_to_all"]),
                                      np.stack([b0[rank], b1[rank]]))
        np.testing.assert_array_equal(r["scatter"], b0[rank])


def test_bf16_sum_and_point_to_point(coll):
    want = (np.float32(1 / 3) + np.float32(2 / 3))
    for r in coll:
        np.testing.assert_allclose(r["bf16_sum"], want, rtol=1e-2)
        np.testing.assert_array_equal(
            np.stack(r["bf16_gather"]),
            [np.full(2, torch.tensor(1.0 + q / 3).bfloat16().item())
             for q in range(2)])
    np.testing.assert_array_equal(coll[0]["p2p"], [2.0, 4.0, 6.0])
    np.testing.assert_array_equal(coll[1]["p2p"], [1.0, 2.0, 3.0])
    for rank, r in enumerate(coll):
        got, done = r["batch_p2p"]
        np.testing.assert_array_equal(got, np.full(2, float(1 - rank)))
        assert done


@pytest.mark.parametrize("op", ["f_all_reduce", "f_all_gather",
                                "f_reduce_scatter", "f_all_to_all",
                                "f_broadcast", "f_ppermute"])
def test_functional_collective_gradients_match_finite_differences(coll, op):
    for r in coll:
        assert r["fd"][op] < 1e-6, (op, r["fd"][op])


def test_mesh_groups_and_axis_index(coll):
    for rank, r in enumerate(coll):
        assert r["mp_slice"] == [0, 1] and r["dp_slice"] == [rank]
        assert r["device_mesh"] == (("dp", "mp"), (1, 2))
        assert r["axis_index"] == (rank, 0)
        np.testing.assert_array_equal(r["f_all_reduce_value"], [3.0, 3.0])


def test_megatron_layers_match_plain(coll):
    for r in coll:
        fwd, dx = r["mlp_diff"]
        assert fwd < 1e-5 and dx < 1e-5, r["mlp_diff"]
        assert r["vocab_emb_diff"] == 0.0
        loss, dlogits = r["pce_diff"]
        assert loss < 1e-10 and dlogits < 1e-10, r["pce_diff"]


def test_stream_task_and_observability_hook(coll):
    for r in coll:
        done, val = r["stream"]
        assert done is True
        np.testing.assert_array_equal(val, [3.0, 3.0])
        assert r["obs_calls"][(("coll", "all_reduce"),)] == 1


def test_a_dead_follower_fails_the_driver_instead_of_hanging():
    import time

    t0 = time.monotonic()
    r0, r1 = spawn(W.dead_follower_session, nprocs=2, timeout=200,
                   pg_timeout=60)
    assert r1 is None
    assert r0 != "served" and "Error" in r0, r0
    assert time.monotonic() - t0 < 150


def test_host_collectives_and_data_parallel(coll):
    for r in coll:
        assert r["host"] == ([3.0], [5])
        np.testing.assert_allclose(r["dp_grad"], [[4.0, 6.0, 8.0]])
    np.testing.assert_allclose(coll[0]["dp_no_sync_grad"], [[3.0, 5.0, 7.0]])
    np.testing.assert_allclose(coll[1]["dp_no_sync_grad"], [[5.0, 7.0, 9.0]])


# -- TCPStore (reference tests/test_store_launch_profiler.py:14-80) ----------

def test_tcp_store_roundtrip():
    from paddlepaddle_tpu_torch.distributed.store import TCPStore

    s = TCPStore(is_master=True)
    c = TCPStore(port=s.port)
    c.set("k", b"v1")
    assert s.get("k") == b"v1"
    assert c.add("cnt", 2) == 2
    assert s.add("cnt", 3) == 5
    assert s.check("k") and not c.check("nope")
    assert c.delete_key("k") and not s.check("k")
    res = {}
    t = threading.Thread(target=lambda: res.update(v=c.get("slow")))
    t.start()
    s.set("slow", b"done")
    t.join(10)
    assert res.get("v") == b"done"
    with pytest.raises(TimeoutError):
        c.wait(["never"], timeout=0.2)


def test_tcp_store_large_value():
    from paddlepaddle_tpu_torch.distributed.store import TCPStore

    s = TCPStore(is_master=True)
    big = bytes(range(256)) * (5 * 4096)  # 5 MiB
    s.set("big", big)
    assert s.get("big") == big
    s.set("empty", b"")
    assert s.get("empty") == b""


def test_tcp_store_rank_assignment():
    from paddlepaddle_tpu_torch.distributed.store import TCPStore

    master = TCPStore(is_master=True)
    ranks = []

    def worker():
        c = TCPStore(port=master.port)
        ranks.append(c.add("next_rank", 1) - 1)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert sorted(ranks) == [0, 1, 2, 3]


# -- the launcher (reference tests/test_store_launch_profiler.py:83-120) ----

def _launch(args, tmp_path, timeout=120):
    env = dict(os.environ)
    env.pop("PADDLE_TRAINER_ID", None)
    env.pop("PADDLE_TRAINERS_NUM", None)
    return subprocess.run(
        [sys.executable, "-m", "paddlepaddle_tpu_torch.distributed.launch"]
        + args, capture_output=True, text=True, timeout=timeout, env=env,
        cwd=ROOT)


def test_launch_cli_runs_script(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(
        "import os, sys\n"
        "for k in ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', "
        "'PADDLE_LOCAL_RANK', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK', "
        "'MASTER_ADDR', 'MASTER_PORT'):\n"
        "    assert k in os.environ, k\n"
        "sys.stdout.write('worker %s of %s\\n' % (os.environ['PADDLE_TRAINER_ID'],\n"
        "                 os.environ['PADDLE_TRAINERS_NUM']))\n")
    out = _launch(["--nproc_per_node", "2", str(script)], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "worker 0 of 2" in out.stdout
    assert "worker 1 of 2" in out.stdout


def test_launch_restart_on_failure(tmp_path):
    marker = tmp_path / "marker"
    script = tmp_path / "flaky.py"
    script.write_text(
        f"import os, sys\n"
        f"m = {str(marker)!r}\n"
        f"if not os.path.exists(m):\n"
        f"    open(m, 'w').close()\n"
        f"    sys.exit(1)\n"
        f"print('recovered', os.environ['PADDLE_RESTART_NUM'])\n")
    out = _launch(["--nproc_per_node", "1", "--max_restarts", "1",
                   str(script)], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "recovered 1" in out.stdout
    # out of restarts: the job fails with the worker's code
    script.write_text("import sys\nsys.exit(3)\n")
    out = _launch(["--nproc_per_node", "1", str(script)], tmp_path)
    assert out.returncode == 3


def test_launch_workers_join_one_process_group(tmp_path):
    """Two launched workers rendezvous on the launcher's store and
    all-reduce over gloo."""
    script = tmp_path / "job.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import torch_dist_workers as W\n"
        # one write a line: the two workers share the launcher's stdout
        "sys.stdout.write('result %s %s\\n' % W.launched_script_body())\n")
    out = _launch(["--nproc_per_node", "2", str(script)], tmp_path,
                  timeout=180)
    assert out.returncode == 0, out.stderr
    assert "result 0 3.0" in out.stdout and "result 1 3.0" in out.stdout


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(_fail_on_rank_1, nprocs=2, timeout=120)


def _fail_on_rank_1():
    import os

    if os.environ["PADDLE_TRAINER_ID"] == "1":
        raise ValueError("rank 1 says no")
    return 0
