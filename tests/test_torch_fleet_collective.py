"""The port's collective ``fleet``, watchdog, comm tasks, ``rpc`` and
``distributed.utils`` on the CPU against the JAX package
(``paddlepaddle_tpu/distributed/fleet/``, ``watchdog.py``,
``comm_task.py``, ``rpc.py``, ``utils.py``, ``amp/grad_scaler.py``).

* ``fleet.init``'s topology as reference ``tests/test_mpu.py:19`` checks
  it (no group: the reference's one controller), and under 4 gloo ranks
  every accessor's coordinate and every group's ranks against the JAX
  ``CommunicateTopology``'s tables (rank bodies in
  ``tests/torch_dist_workers.py``);
* ``fleet.distributed_optimizer`` over AdamW and over SGD, each with a
  ``ClipGradByGlobalNorm`` that binds, on ``mp2`` (a column- then a
  row-parallel layer): losses and the whole weights after 3 steps against
  the JAX package's one process with the same weights (losses rtol 1e-5,
  weights 1e-5 absolute). Adam is blind to a uniform gradient scale, so
  the SGD arm is the one that shows a clip norm not summed over ``mp``;
* ``GradScaler``: rank 1 alone sees an inf and both ranks skip (the MAX
  over the host group, reference ``amp/grad_scaler.py:59-68``);
  ``LocalSGD`` averages over the host group at its k-th step (reference
  ``tests/test_host_collectives.py:95``);
* the RNG tracker (reference ``tests/test_mpu.py:86``), the data
  generators and ``UtilBase`` (``tests/test_watchdog_text_audio.py:319``),
  the refusals (``strategy.dgc``, ``global_scatter``);
* the watchdog and comm-task cases of
  ``tests/test_watchdog_text_audio.py`` and the rpc round trip and
  exception of ``tests/test_rpc_tuner_geometric.py``.
"""

import time

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import fleet, spawn

TOPOLOGIES = [{"dp_degree": 2, "mp_degree": 2},
              {"pp_degree": 2, "mp_degree": 2},
              {"dp_degree": 2, "sharding_degree": 2},
              {}]                          # all 1: dp takes the job
_NAMES = ("data", "pipe", "sharding", "sep", "model")
_KEYS = ("dp_degree", "pp_degree", "sharding_degree", "sep_degree",
         "mp_degree")


def _jax_topology(hc, world=4):
    from paddlepaddle_tpu.distributed.fleet import CommunicateTopology

    dims = [max(1, hc.get(k, 1)) for k in _KEYS]
    if dims == [1] * 5:
        dims[0] = world
    return CommunicateTopology(_NAMES, dims)


@pytest.fixture(autouse=True)
def _meshes_left_as_found():
    """``fleet.init`` sets its package's global mesh: each test leaves both
    packages' as it found them, so a later test in this process (another
    file on the same worker) sees none."""
    from paddlepaddle_tpu.distributed import mesh as jmesh
    from paddlepaddle_tpu_torch.distributed import mesh as tmesh

    saved = jmesh.get_mesh(), tmesh.get_mesh()
    yield
    jmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])


@pytest.fixture(scope="module")
def topology_runs():
    return spawn(W.fleet_topology_session, args=(TOPOLOGIES,), nprocs=4,
                 timeout=300, pg_timeout=120)


def test_fleet_init_topology_without_a_group():
    """Reference tests/test_mpu.py:19, in a process with no group."""
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 2,
                               "sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_model_parallel_world_size() == 2
    assert hcg.get_data_parallel_world_size() == 2
    assert hcg.get_sharding_parallel_world_size() == 2
    assert hcg.topology().world_size() == 8
    assert hcg.mesh.get_dim_size("mp") == 2
    # one controller: rank 0 of every axis, the reference's group ranks
    from paddlepaddle_tpu.distributed import fleet as jfleet

    jfleet.init(is_collective=True, strategy=strategy)
    jh = jfleet.get_hybrid_communicate_group()
    for acc in ("get_data_parallel_rank", "get_model_parallel_rank",
                "get_stage_id", "get_sharding_parallel_rank",
                "get_sep_parallel_rank", "get_data_parallel_group_src_rank",
                "get_model_parallel_group_src_rank"):
        assert getattr(hcg, acc)() == getattr(jh, acc)() == 0, acc
    for acc in ("get_data_parallel_group", "get_model_parallel_group",
                "get_sharding_parallel_group", "get_pipe_parallel_group"):
        assert getattr(hcg, acc)().ranks == getattr(jh, acc)().ranks, acc
    assert hcg.get_parallel_mode() == jh.get_parallel_mode()
    assert hcg.get_rank_from_stage(0) == jh.get_rank_from_stage(0)
    assert fleet.worker_index() == jfleet.worker_index() == 0
    assert fleet.is_first_worker() and jfleet.is_first_worker()
    assert fleet.fleet.worker_num == jfleet.fleet.worker_num == 8
    assert fleet.distributed_model is not None
    m = torch.nn.Linear(2, 2)
    assert fleet.distributed_model(m) is m
    opt = pt.SGD(parameters=m.parameters())
    assert fleet.distributed_optimizer(opt) is opt


@pytest.mark.parametrize("idx", range(len(TOPOLOGIES)))
def test_rank_coordinate_tables_on_four_ranks(topology_runs, idx):
    """Each rank's accessors and groups against the JAX
    CommunicateTopology's rank <-> coordinate tables."""
    topo = _jax_topology(TOPOLOGIES[idx])
    for rank, runs in enumerate(topology_runs):
        got = runs[idx]
        assert got["global_rank"] == got["worker_index"] == rank
        assert got["first"] == (rank == 0)
        assert got["coord"] == topo.get_coord(rank)
        for name in _NAMES:
            row = next(r for r in topo.get_comm_list(name) if rank in r)
            assert got["groups"][name] == row, (rank, name)
        assert got["src"]["data"] == got["groups"]["data"][0]
        assert got["src"]["model"] == got["groups"]["model"][0]
        stage = min(1, topo.get_dim("pipe") - 1)
        assert got["stage1_rank"] == topo.get_rank(
            **dict(topo.get_coord(rank), pipe=stage))
        assert got["mp_sum"] == float(sum(got["groups"]["model"]))
        assert got["dp_model"] == ("DataParallel" if topo.get_dim("data") > 1
                                   else "Linear")


def _mlp_problem():
    rng = np.random.default_rng(5)
    weights = {"w1": rng.standard_normal((6, 8)).astype(np.float32),
               "b1": rng.standard_normal((8,)).astype(np.float32) * 0.1,
               "w2": rng.standard_normal((8, 3)).astype(np.float32),
               "b2": rng.standard_normal((3,)).astype(np.float32) * 0.1}
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = rng.standard_normal((5, 3)).astype(np.float32)
    return weights, x, y


CLIP, STEPS = 0.5, 3


def _jax_mlp(weights, x, y, name):
    """The reference's one process: two Linears, the same optimizer and
    clip, STEPS steps."""
    l1, l2 = paddle.nn.Linear(6, 8), paddle.nn.Linear(8, 3)
    l1.weight.set_value(weights["w1"])
    l1.bias.set_value(weights["b1"])
    l2.weight.set_value(weights["w2"])
    l2.bias.set_value(weights["b2"])
    params = l1.parameters() + l2.parameters()
    clip = paddle.nn.ClipGradByGlobalNorm(CLIP)
    opt = (paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params,
                                  grad_clip=clip)
           if name == "adamw" else
           paddle.optimizer.SGD(learning_rate=0.1, parameters=params,
                                grad_clip=clip))
    xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
    losses = []
    for _ in range(STEPS):
        out = l2(paddle.nn.functional.relu(l1(xt)))
        loss = ((out - yt) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, {"w1": l1.weight.numpy(), "b1": l1.bias.numpy(),
                    "w2": l2.weight.numpy(), "b2": l2.bias.numpy()}


@pytest.fixture(scope="module")
def mp2_runs():
    weights, x, y = _mlp_problem()
    grads = np.ones((2, 4), np.float32)
    grads[1, 2] = np.inf                     # rank 1 alone sees an inf
    got = spawn(W.fleet_mp2_session,
                args=(weights, x, y, CLIP, STEPS, grads), nprocs=2,
                timeout=300, pg_timeout=120)
    ref = {name: _jax_mlp(weights, x, y, name) for name in ("adamw", "sgd")}
    return got, ref


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_distributed_optimizer_on_mp2_matches_one_process(mp2_runs, name):
    got, ref = mp2_runs
    want_losses, want_w = ref[name]
    for r in got:
        assert r[name]["wrapped"] == "HybridParallelOptimizer"
        np.testing.assert_allclose(r[name]["losses"], want_losses,
                                   rtol=1e-5)
        for k, v in want_w.items():
            np.testing.assert_allclose(r[name]["weights"][k], v, atol=1e-5,
                                       err_msg=f"rank {r['rank']} {k}")


def test_grad_scaler_skips_on_every_rank_together(mp2_runs):
    got, _ = mp2_runs
    for r in got:
        assert r["scaler"] == {"found_inf": True, "stepped": False,
                               "scale": 2.0}, r["rank"]


def test_localsgd_averages_over_the_host_group(mp2_runs):
    got, _ = mp2_runs
    for r in got:
        np.testing.assert_allclose(r["localsgd"][0], float(r["rank"] + 1))
        np.testing.assert_allclose(r["localsgd"][1], 1.5)


def test_rng_state_tracker():
    """Reference tests/test_mpu.py:86: the tracked stream differs from the
    global one and advances; a reseed reproduces it; its states round
    trip."""
    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.distributed.fleet import (
        get_rng_state_tracker, model_parallel_random_seed)

    def draw():
        return torch.rand(4, generator=prandom.torch_generator("cpu"))

    assert model_parallel_random_seed(1234) == (1234, 2258)
    tracker = get_rng_state_tracker()
    with tracker.rng_state():
        a = draw()
    with tracker.rng_state():
        b = draw()
    c = draw()
    assert not torch.allclose(a, c) and not torch.allclose(a, b)
    model_parallel_random_seed(1234)
    with tracker.rng_state():
        assert torch.equal(draw(), a)
    states = tracker.get_states_tracker()
    with tracker.rng_state():
        d = draw()
    tracker.set_states_tracker(states)
    with tracker.rng_state():
        assert torch.equal(draw(), d)
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("model_parallel_rng", 99)
    with pytest.raises(ValueError, match="does not exist"):
        with tracker.rng_state("nope"):
            pass


def test_data_generators_util_and_role_makers():
    """Reference tests/test_watchdog_text_audio.py:319, both packages."""
    from paddlepaddle_tpu.distributed import fleet as jfleet

    for pkg in (fleet, jfleet):
        class G(pkg.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def gen():
                    toks = line.split()
                    yield [("words", toks[:-1]), ("label", [toks[-1]])]

                return gen

        g = G()
        lines = g.run_from_memory(["1926 08 17 1", "3 4 0"])
        assert lines == ["3 1926 08 17 1 1\n", "2 3 4 1 0\n"]
        with pytest.raises(ValueError, match="consistent"):
            g._gen_str([("other", ["1"])])
        util = pkg.UtilBase()
        files = [f"f{i}" for i in range(7)]
        assert util.get_file_shard(files) == files
        assert util.all_gather(5) == [5]
        np.testing.assert_array_equal(util.all_reduce(np.ones(3)),
                                      np.ones(3))
        assert isinstance(pkg.fleet, pkg.Fleet)
        rm = pkg.UserDefinedRoleMaker(current_id=3, worker_num=4)
        assert rm._is_worker() and pkg.Role.WORKER == 1
        assert (rm._worker_index(), rm._worker_num()) == (3, 4)


def test_refusals_name_what_they_wait_for():
    strategy = fleet.DistributedStrategy()
    strategy.dgc = True
    with pytest.raises(NotImplementedError, match="item 4"):
        fleet.distributed_optimizer(pt.Momentum(
            parameters=torch.nn.Linear(2, 2).parameters()), strategy)
    from paddlepaddle_tpu_torch.distributed.utils import (global_gather,
                                                         global_scatter)

    for fn in (global_scatter, global_gather):
        with pytest.raises(NotImplementedError, match="parallel.moe"):
            fn(None, None, None)
    strategy = fleet.DistributedStrategy()
    strategy.localsgd = True
    strategy.localsgd_configs = {"k_steps": 3, "begin_step": 2}
    lsgd = fleet.distributed_optimizer(
        pt.SGD(parameters=torch.nn.Linear(2, 2).parameters()), strategy)
    assert isinstance(lsgd, fleet.LocalSGD) and lsgd._k == 3


# -- watchdog and comm tasks (reference tests/test_watchdog_text_audio.py) --

def test_watchdog_fires_on_hang():
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog

    fired = []
    wd = Watchdog(timeout=0.3, poll_interval=0.05, abort=False,
                  on_timeout=lambda name, el: fired.append((name, el)))
    with wd:
        with wd.step("slow_step"):
            time.sleep(0.8)
    assert fired and fired[0][0] == "slow_step"


def test_watchdog_attributes_in_flight_collective(capsys):
    """A timeout names the op and group in flight and the region around
    it (the port's RecordEvent is a region task)."""
    from paddlepaddle_tpu_torch.distributed.comm_task import (comm_task,
                                                             in_flight)
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog
    from paddlepaddle_tpu_torch.observability import RecordEvent

    wd = Watchdog(timeout=0.3, poll_interval=0.05, abort=False)
    with wd:
        with wd.step("hung_step"):
            with RecordEvent("forward"), comm_task("store.get('peer/0')",
                                                   group="store"):
                time.sleep(0.8)
    err = capsys.readouterr().err
    assert "store.get('peer/0')" in err and "group=store" in err
    assert "forward" in err and "group=region" in err
    names = [t[0] for t in wd.last_in_flight]
    assert "store.get('peer/0')" in names and "forward" in names
    assert in_flight() == []


def test_watchdog_quiet_on_fast_steps():
    from paddlepaddle_tpu_torch.distributed.watchdog import Watchdog

    fired = []
    wd = Watchdog(timeout=5.0, poll_interval=0.05, abort=False,
                  on_timeout=lambda *a: fired.append(a))
    with wd:
        for _ in range(3):
            with wd.step():
                time.sleep(0.01)
    assert not fired


def test_store_waits_and_host_collectives_are_comm_tasks():
    """A blocked store wait and a host collective show in the in-flight
    table while they block, and the comm-task histogram counts them once
    observability is on."""
    import threading

    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.distributed.comm_task import in_flight
    from paddlepaddle_tpu_torch.distributed.host_collectives import \
        HostProcessGroup
    from paddlepaddle_tpu_torch.distributed.store import TCPStore

    store = TCPStore(is_master=True, timeout=10)
    g0 = HostProcessGroup(store, 0, 2)
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        g0.all_reduce(np.ones(2, np.float32))))
    obs.enable(trace=False, metrics=True, watchdog_=False)
    try:
        t.start()
        deadline = time.monotonic() + 5
        names = []
        while time.monotonic() < deadline and not any(
                n.startswith("store.wait") for n in names):
            names = [x[0] for x in in_flight()]
            time.sleep(0.01)
        assert "host_collectives.all_reduce#1" in names
        assert "host_collectives.all_gather#1" in names
        assert any(n.startswith("store.wait") for n in names)
        g1 = HostProcessGroup(TCPStore(port=store.port, timeout=10), 1, 2)
        np.testing.assert_array_equal(g1.all_reduce(np.ones(2, np.float32)),
                                      [2.0, 2.0])
        t.join(10)
        np.testing.assert_array_equal(seen[0], [2.0, 2.0])
        snap = obs.snapshot()["paddle_comm_task_seconds"]
        groups = {dict(k).get("group") for k in snap}
        assert {"host/0", "store"} <= groups
    finally:
        obs.disable()
    assert in_flight() == []


# -- rpc (reference tests/test_rpc_tuner_geometric.py) -----------------------

def _double(x):
    return 2 * x


def _add(a, b):
    return a + b


def _raise_value_error():
    raise ValueError("boom from the rpc worker")


def test_rpc_sync_async_roundtrip():
    from paddlepaddle_tpu_torch.distributed import rpc

    rpc.init_rpc("worker0", rank=0, world_size=1)
    try:
        info = rpc.get_worker_info("worker0")
        assert info.rank == 0 and info.port > 0
        assert rpc.rpc_sync("worker0", _double, args=(21,)) == 42
        fut = rpc.rpc_async("worker0", _add, args=(1, 2))
        assert fut.result(timeout=30) == 3
        assert [w.name for w in rpc.get_all_worker_infos()] == ["worker0"]
    finally:
        rpc.shutdown()


def test_rpc_exception_propagates():
    from paddlepaddle_tpu_torch.distributed import rpc

    rpc.init_rpc("workerE", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="boom"):
            rpc.rpc_sync("workerE", _raise_value_error)
        with pytest.raises(KeyError, match="no rpc worker"):
            rpc.get_worker_info("nobody")
    finally:
        rpc.shutdown()
