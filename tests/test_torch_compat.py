"""The port's ``distributed.compat`` (``paddlepaddle_tpu_torch/distributed/
compat.py``) against the JAX package's (``paddlepaddle_tpu/distributed/
compat.py``) on the CPU.

* One process (no group): each collective's answer equals the JAX
  package's on the same inputs (``alltoall_single``, ``alltoall``,
  ``gather``, ``broadcast_object_list``, ``scatter_object_list``), the
  environment view, ``ParallelMode``, ``ReduceType``, ``Strategy``,
  ``split`` and the parameter-server stubs raising alike.
* Two gloo ranks through the port's ``spawn`` (rank bodies in
  ``tests/torch_dist_workers.py``): ``alltoall_single`` with uneven split
  sizes and even, ``alltoall``, ``gather``, ``broadcast_object_list``,
  ``scatter_object_list`` and ``ParallelEnv`` against numpy and the
  launcher's environment, then ``destroy_process_group``.
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.distributed.compat as JC
import paddlepaddle_tpu_torch.distributed as tdist
import paddlepaddle_tpu_torch.distributed.compat as TC
from paddlepaddle_tpu_torch.distributed import spawn

import torch_dist_workers as W


def test_single_process_answers_equal_the_reference(monkeypatch):
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT"):
        monkeypatch.delenv(k, raising=False)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    out_t = torch.empty(0, 3)
    TC.alltoall_single(out_t, torch.from_numpy(x))
    out_j = paddle.to_tensor(np.zeros((4, 3), np.float32))
    JC.alltoall_single(out_j, paddle.to_tensor(x))
    np.testing.assert_array_equal(out_t.numpy(), out_j.numpy())
    got_t, got_j = [], []
    TC.alltoall(got_t, [torch.ones(2), torch.zeros(2)])
    JC.alltoall(got_j, [paddle.to_tensor(np.ones(2, np.float32)),
                        paddle.to_tensor(np.zeros(2, np.float32))])
    assert len(got_t) == len(got_j)
    for a, b in zip(got_t, got_j):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    gt, gj = [], []
    TC.gather(torch.tensor([2.0]), gt)
    JC.gather(paddle.to_tensor(np.asarray([2.0], np.float32)), gj)
    assert [t.numpy().tolist() for t in gt] == [t.numpy().tolist()
                                                for t in gj]
    objs = [{"a": 1}, "b"]
    assert TC.broadcast_object_list(list(objs)) == \
        JC.broadcast_object_list(list(objs)) == objs
    ot, oj = [], []
    TC.scatter_object_list(ot, [7, 8])
    JC.scatter_object_list(oj, [7, 8])
    assert ot == oj == [7]
    et, ej = TC.ParallelEnv(), JC.ParallelEnv()
    for attr in ("rank", "world_size", "nranks", "local_rank", "device_id",
                 "dev_id", "current_endpoint", "trainer_endpoints"):
        assert getattr(et, attr) == getattr(ej, attr), attr
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "h0:1,h1:2")
    assert et.trainer_endpoints == ej.trainer_endpoints == ["h0:1", "h1:2"]
    assert TC.wait(out_t) is out_t
    assert TC.is_available() and TC.get_backend() is None


def test_enums_bags_and_stubs_match_the_reference():
    assert {m.name: m.value for m in TC.ParallelMode} == \
        {m.name: m.value for m in JC.ParallelMode}
    assert {k: v for k, v in vars(TC.ReduceType).items()
            if k.startswith("kRed")} == \
        {k: v for k, v in vars(JC.ReduceType).items()
         if k.startswith("kRed")}
    st, sj = TC.Strategy({"foo": 3}), JC.Strategy({"foo": 3})
    assert st.foo == sj.foo == 3
    assert st.sharding.enable is sj.sharding.enable is False
    for name in ("QueueDataset", "InMemoryDataset", "CountFilterEntry",
                 "ShowClickEntry", "ProbabilityEntry"):
        with pytest.raises(NotImplementedError, match="parameter-server"):
            getattr(TC, name)()
        with pytest.raises(NotImplementedError, match="parameter-server"):
            getattr(JC, name)()
    with pytest.raises(NotImplementedError, match="mpu"):
        TC.split(None, (2, 2), "linear")
    scaler = object()
    assert TC.shard_scaler(scaler) is scaler
    da = TC.DistAttr("mesh", ["x", None])
    assert (da.process_mesh, da.sharding_specs) == ("mesh", ["x", None])
    t = torch.arange(3.0)
    assert torch.equal(TC.unshard_dtensor(t), t)
    assert TC.spawn is tdist.spawn
    for name in ("alltoall_single", "broadcast_object_list", "ParallelEnv",
                 "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
                 "destroy_process_group", "Strategy"):
        assert getattr(tdist, name) is getattr(TC, name)
    assert tdist.AutoTuner is not None and tdist.TuneConfig is not None


def test_two_gloo_ranks_against_numpy():
    r0, r1 = spawn(W.compat_session, nprocs=2, timeout=240)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for r in (r0, r1):
        assert r["backend"] == "gloo" and r["available"]
        assert r["wait_is_identity"] and r["destroyed"]
        assert r["env"][:3] == [r["rank"], 2, 2]
        assert r["env"][3] == r["env"][4] == r["rank"]
    # the numpy oracle of alltoall_single: rank s sends its rows
    # [sum(splits_s[:j]), +splits_s[j]) to rank j
    sends = {}
    for s in range(2):
        splits = [s + 1, s + 2]
        x = np.arange(sum(splits) * 3, dtype=np.float32).reshape(-1, 3) \
            + 100 * s
        offs = np.cumsum([0] + splits)
        sends[s] = [x[offs[j]:offs[j + 1]] for j in range(2)]
    for j, r in ((0, r0), (1, r1)):
        want = np.concatenate([sends[s][j] for s in range(2)])
        np.testing.assert_array_equal(r["alltoall_single"], want)
        np.testing.assert_array_equal(
            r["alltoall_single_even"],
            np.concatenate([np.arange(2 * j, 2 * j + 2) + 10 * s
                            for s in range(2)]))
        assert [a.tolist() for a in r["alltoall"]] == \
            [[10.0 * s + j] * 2 for s in range(2)]
        assert r["broadcast_object_list"] == [
            {"from": 1, "tags": ["a", 1]}, (1, 2.5)]
        assert r["scatter_object_list"] == [{"to": j,
                                             "payload": list(range(j + 2))}]
    assert [g.tolist() for g in r0["gather"]] == [[0.0], [1.5]]
    assert r1["gather"] == []
