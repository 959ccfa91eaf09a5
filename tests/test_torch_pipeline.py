"""The port's pipeline API and executor on the CPU against the JAX package
(``paddlepaddle_tpu/parallel/pipeline.py``, ``pipeline_spmd.py``):

* ``LayerDesc`` / ``SegmentLayers`` / ``PipelineLayer`` /
  ``PipelineParallel``: the same segments, the same outputs on the same
  weights, the same microbatched ``train_batch`` losses
  (``tests/test_pipeline.py:16-47``);
* ``spmd_pipeline_train`` with the reference test's toy block
  (``tests/test_pipeline_schedules.py:175-237``) for all five schedules
  on ``dp2 pp2`` and on ``pp4``, four gloo ranks from the port's
  ``spawn`` (rank body ``tests/torch_dist_workers.py:
  pipeline_toy_session``), against the JAX executor on four of its eight
  virtual CPU devices: loss, stage grads, head grads and the input
  cotangent within 1e-5 on every rank; ``spmd_pipeline`` and
  ``spmd_pipeline_interleaved`` against the JAX ones (2e-5);
* the single-process form (this process as rank 0, no process group)
  against the SPMD form, bit for bit, its workers gone after the call.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.nn import functional as JF
from paddlepaddle_tpu.parallel import pipeline as JP
from paddlepaddle_tpu.parallel import pipeline_spmd as JS

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import ProcessMesh, spawn
from paddlepaddle_tpu_torch.parallel import pipeline as TP
from paddlepaddle_tpu_torch.parallel import pipeline_spmd as TS

M, B, H = 8, 16, 8
SCHEDULES = [("1f1b", 1), ("gpipe", 1), ("interleaved", 2), ("zbh1", 1),
             ("zbvpp", 2)]
MESHES = {"dp2pp2": ([2, 2], ["dp", "pp"], "dp"),
          "pp4": ([4], ["pp"], None)}
TRAIN = [(mesh, name, V) for mesh in MESHES for name, V in SCHEDULES]
FORWARD = [("fwd dp2pp2", "dp2pp2", False), ("fwd pp4", "pp4", False),
           ("vpp dp2pp2", "dp2pp2", True)]
SINGLE = [("dp2pp2", "1f1b", 1), ("dp2pp2", "zbvpp", 2)]


def _toy(G, seed):
    r = np.random.default_rng(seed)
    stages = [{"w": (r.standard_normal((H, H)) / np.sqrt(H)).astype(
                   np.float32),
               "b": (r.standard_normal((H,)) * 0.1).astype(np.float32)}
              for _ in range(G)]
    head = {"wo": (r.standard_normal((H, 1)) / np.sqrt(H)).astype(
        np.float32)}
    x = r.standard_normal((B, H)).astype(np.float32)
    y = r.standard_normal((B, 1)).astype(np.float32)
    return stages, head, x, y


def _stack(stages, S, V, mod):
    st = [{k: mod(v) for k, v in s.items()} for s in stages]
    if mod is torch.from_numpy:
        return (TS.stack_stage_params(st) if V == 1
                else TS.stack_virtual_stage_params(st, S))
    return (JS.stack_stage_params(st) if V == 1
            else JS.stack_virtual_stage_params(st, S))


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))


def _jblock(p, a):
    return jnp.tanh(a @ p["w"] + p["b"])


def _jhead(hp, a, y):
    return jnp.mean((a @ hp["wo"] - y) ** 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _arm(mesh, name, V):
    shape, names, dax = MESHES[mesh]
    S = shape[-1]
    stages, head, x, y = _toy(V * S, seed=TRAIN.index((mesh, name, V)))
    return shape, names, dax, S, stages, head, x, y


def _jax_arm(arm):
    """The JAX executor's outputs for one TRAIN arm, as numpy."""
    mesh, name, V = arm
    shape, names, dax, S, stages, head, x, y = _arm(mesh, name, V)
    return _np(JS.spmd_pipeline_train(
        _stack(stages, S, V, jnp.asarray),
        {k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(x),
        jnp.asarray(y), _jblock, _jhead, _jax_mesh(shape, names),
        schedule=name, n_microbatches=M, num_virtual=V, pp_axis="pp",
        data_axis=dax))


def _forward_problem(key, mesh, inter):
    shape, names, dax = MESHES[mesh]
    S, V, Mf = shape[-1], 2 if inter else 1, 4
    r = np.random.default_rng(3)
    per = [{"w": (r.standard_normal((H, H)) / np.sqrt(H)).astype(
                np.float32)} for _ in range(S * V)]
    x = r.standard_normal((Mf * 2, 16, H)).astype(np.float32)
    return shape, names, dax, S, V, Mf, per, x


@pytest.fixture(scope="module")
def toy():
    """The port's four ranks, then the single-process form, run in a
    thread while this process runs the JAX executors."""
    train_arms, fwd_arms = [], []
    for mesh, name, V in TRAIN:
        shape, names, dax, S, stages, head, x, y = _arm(mesh, name, V)
        train_arms.append(((mesh, name), _np(_stack(stages, S, V,
                                                    jnp.asarray)),
                           head, x, y, name, V, shape, names, dax))
    for key, mesh, inter in FORWARD:
        shape, names, dax, S, V, Mf, per, x = _forward_problem(key, mesh,
                                                               inter)
        fwd_arms.append((key, _np(_stack(per, S, V, jnp.asarray)), x, Mf,
                         shape, names, dax, inter))
    job = {}

    def run():
        try:
            job["ranks"] = spawn(W.pipeline_toy_session,
                                 args=(train_arms, fwd_arms), nprocs=4,
                                 timeout=300, pg_timeout=120)
            job["single"] = _single_process_runs()
        except BaseException as e:  # noqa: BLE001 — raised below
            job["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    # the JAX executors compile in four threads (XLA lets go of the GIL)
    with ThreadPoolExecutor(4) as pool:
        ref = dict(zip([(mesh, name) for mesh, name, _ in TRAIN],
                       pool.map(_jax_arm, TRAIN)))
    for key, mesh, inter in FORWARD:
        shape, names, dax, S, V, Mf, per, x = _forward_problem(key, mesh,
                                                               inter)
        fn = JS.spmd_pipeline_interleaved if inter else JS.spmd_pipeline
        ref[key] = np.asarray(fn(
            _stack(per, S, V, jnp.asarray), jnp.asarray(x),
            lambda p, a: jnp.tanh(a @ p["w"]), _jax_mesh(shape, names),
            n_microbatches=Mf, pp_axis="pp", data_axis=dax))
    thread.join()
    if "error" in job:
        raise job["error"]
    return ref, job["ranks"], job["single"]


def _single_process_runs():
    """Each SINGLE arm from this process (no process group): the call
    starts its own ranks. Returns ``{arm: (outputs, child pids left)}``."""
    single = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mesh, name, V in SINGLE:
            shape, names, dax, S, stages, head, x, y = _arm(mesh, name, V)
            before = set(_children())
            got = TS.spmd_pipeline_train(
                _stack(stages, S, V, torch.from_numpy),
                {k: torch.from_numpy(v) for k, v in head.items()},
                torch.from_numpy(x), torch.from_numpy(y), W.toy_block,
                lambda hp, a, y_: ((a @ hp["wo"] - y_) ** 2).mean(),
                ProcessMesh(shape=shape, dim_names=names), schedule=name,
                n_microbatches=M, num_virtual=V, data_axis=dax)
            single[(mesh, name)] = (W._numpy(got),
                                    set(_children()) - before)
    finally:
        torch.set_num_threads(threads)
    return single


def _children():
    import multiprocessing as mp

    return [p.pid for p in mp.active_children()]


@pytest.mark.parametrize("mesh,name,V", TRAIN)
def test_executor_matches_the_reference_executor(toy, mesh, name, V):
    ref, ranks, _ = toy
    loss, g, hg, dx = ref[(mesh, name)]
    for r in ranks:
        got = r[(mesh, name)]
        assert abs(float(got[0]) - float(loss)) < 1e-5
        for k in ("w", "b"):
            assert got[1][k].shape == g[k].shape
            np.testing.assert_allclose(got[1][k], g[k], atol=1e-5)
        np.testing.assert_allclose(got[2]["wo"], hg["wo"], atol=1e-5)
        np.testing.assert_allclose(got[3], dx, atol=1e-5)


@pytest.mark.parametrize("key,mesh,inter", FORWARD)
def test_forward_pipelines_match_the_reference(toy, key, mesh, inter):
    ref, ranks, _ = toy
    for r in ranks:
        np.testing.assert_allclose(r[key], ref[key], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh,name,V", SINGLE)
def test_single_process_form_is_bit_equal_to_spmd(toy, mesh, name, V):
    _, ranks, single = toy
    got, leftover = single[(mesh, name)]
    want = ranks[0][(mesh, name)]
    assert float(got[0]) == float(want[0])
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(got[3], want[3])
    assert leftover == set()           # the call's worker ranks are gone


def test_single_process_form_refuses_an_unshippable_block():
    from paddlepaddle_tpu_torch.distributed.ship import ShipError

    lock = threading.Lock()
    stages, head, x, y = _toy(2, 0)

    def block(p, a):
        with lock:
            return W.toy_block(p, a)

    with pytest.raises(ShipError, match="block_fn"):
        TS.spmd_pipeline_train(
            _stack(stages, 2, 1, torch.from_numpy),
            {k: torch.from_numpy(v) for k, v in head.items()},
            torch.from_numpy(x), torch.from_numpy(y), block,
            W.toy_head_loss, ProcessMesh(shape=[2], dim_names=["pp"]),
            n_microbatches=M)


def test_seq_axis_raises_naming_the_later_slice():
    """``seq_axis`` runs since A10 slice 5 (its parity case is the 5-D
    hybrid of ``tests/test_torch_hybrid.py``); what it still refuses is
    what the reference refuses: activations with no sequence dim raise
    ``ValueError`` in both packages (reference :384-386), and an axis the
    mesh lacks raises in the port before any rank starts."""
    stages, head, x, y = _toy(2, 0)
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("sp", "pp"))
    with pytest.raises(ValueError, match="needs activations"):
        JS.spmd_pipeline_train(
            _stack(stages, 2, 1, jnp.asarray), {}, jnp.asarray(x),
            jnp.asarray(y), lambda p, a: a, lambda hp, a, t: jnp.sum(a),
            jmesh, n_microbatches=M, seq_axis="sp")
    with pytest.raises(ValueError, match="needs activations"):
        TS.spmd_pipeline_train(
            _stack(stages, 2, 1, torch.from_numpy), {}, torch.from_numpy(x),
            torch.from_numpy(y), W.toy_block, W.toy_head_loss,
            ProcessMesh(shape=[2, 2], dim_names=["sp", "pp"]),
            n_microbatches=M, seq_axis="sp")
    with pytest.raises(ValueError, match="not in the mesh"):
        TS.spmd_pipeline_train(
            _stack(stages, 2, 1, torch.from_numpy), {}, torch.from_numpy(x),
            torch.from_numpy(y), W.toy_block, W.toy_head_loss,
            ProcessMesh(shape=[2], dim_names=["pp"]), n_microbatches=M,
            seq_axis="sp")


def test_stacking_matches_the_reference():
    stages, _, _, _ = _toy(4, 1)
    for V in (1, 2):
        t = _stack(stages, 4 // V, V, torch.from_numpy)
        j = _np(_stack(stages, 4 // V, V, jnp.asarray))
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), j[k])
    with pytest.raises(ValueError, match="not divisible"):
        TS.stack_virtual_stage_params(
            [{"w": torch.zeros(1)}] * 3, 2)


# ---------------------------------------------------------------------------
# the fleet API
# ---------------------------------------------------------------------------


def test_segment_uniform_and_by_layer():
    for n, k in ((10, 4), (8, 4), (7, 3)):
        assert TP.SegmentLayers.uniform(n, k) == JP.SegmentLayers.uniform(n, k)
    t = [TP.LayerDesc(pt.nn.Linear, 4, 4, device="cpu"),
         TP.LayerDesc(pt.nn.ReLU), TP.LayerDesc(pt.nn.Linear, 4, 4,
                                                device="cpu"),
         TP.LayerDesc(pt.nn.ReLU), TP.LayerDesc(pt.nn.Linear, 4, 4,
                                                device="cpu")]
    j = [JP.LayerDesc(paddle.nn.Linear, 4, 4), JP.LayerDesc(paddle.nn.ReLU),
         JP.LayerDesc(paddle.nn.Linear, 4, 4), JP.LayerDesc(paddle.nn.ReLU),
         JP.LayerDesc(paddle.nn.Linear, 4, 4)]
    for parts in (2, 3):
        assert TP.SegmentLayers(t, parts, "layer:Linear").do_segment() == \
            JP.SegmentLayers(j, parts, "layer:Linear").do_segment()
    with pytest.raises(ValueError, match="only 3 'Linear' layers"):
        TP.SegmentLayers(t, 4, "layer:Linear").do_segment()
    with pytest.raises(TypeError, match="Layer subclass"):
        TP.LayerDesc(lambda: None)
    with pytest.raises(TypeError, match="Layer subclass"):
        JP.LayerDesc(int)


def _same_weights(tpl, jpl):
    state = {k: torch.from_numpy(np.asarray(v.numpy()).copy())
             for k, v in jpl.state_dict().items()}
    tpl.load_state_dict(state, strict=True)


def test_pipeline_layer_build_stages_and_forward():
    jpl = JP.PipelineLayer([JP.LayerDesc(paddle.nn.Linear, 8, 8)
                            for _ in range(6)], num_stages=3)

    class Topo:
        def get_dim(self, name):
            assert name == "pipe"
            return 3

    tpl = TP.PipelineLayer([TP.LayerDesc(pt.nn.Linear, 8, 8, device="cpu")
                            for _ in range(6)], topology=Topo(),
                           loss_fn=lambda out, lb: pt.nn.functional.mse_loss(
                               out, lb))
    assert tpl.get_num_stages() == jpl.get_num_stages() == 3
    assert tpl.segment_parts == jpl.segment_parts == [0, 2, 4, 6]
    for i in range(6):
        assert tpl.stage_of_layer(i) == jpl.stage_of_layer(i)
    assert [len(tpl.get_stage_layers(s)) for s in range(3)] == [2, 2, 2]
    _same_weights(tpl, jpl)
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    want = np.asarray(jpl(paddle.to_tensor(x)).numpy())
    got = tpl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_train_batch_matches_the_reference():
    """Microbatched accumulation: the same two losses as the JAX
    ``train_batch`` on the same weights and batch, and the same
    ``eval_batch``."""
    paddle.seed(7)
    jpl = JP.PipelineLayer([JP.LayerDesc(paddle.nn.Linear, 4, 4)
                            for _ in range(4)], num_stages=2,
                           loss_fn=lambda out, lb: JF.mse_loss(out, lb))
    tpl = TP.PipelineLayer([TP.LayerDesc(pt.nn.Linear, 4, 4, device="cpu")
                            for _ in range(4)], num_stages=2,
                           loss_fn=lambda out, lb: pt.nn.functional.mse_loss(
                               out, lb))
    _same_weights(tpl, jpl)
    jpp = JP.PipelineParallel(
        jpl, accumulate_steps=4)
    tpp = TP.PipelineParallel(tpl, accumulate_steps=4)
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jpl.parameters())
    topt = pt.SGD(learning_rate=0.1, parameters=tpl.parameters())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    want, got = [], []
    for _ in range(2):
        want.append(float(jpp.train_batch(
            (paddle.to_tensor(x), paddle.to_tensor(y)), jopt).numpy()))
        got.append(float(tpp.train_batch(
            (torch.from_numpy(x), torch.from_numpy(y)), topt)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] < got[0]
    np.testing.assert_allclose(
        float(tpp.eval_batch((torch.from_numpy(x), torch.from_numpy(y)))),
        float(jpp.eval_batch((paddle.to_tensor(x),
                              paddle.to_tensor(y))).numpy()), rtol=1e-5)
    with pytest.raises(ValueError, match="divisible by accumulate_steps"):
        tpp.train_batch((torch.zeros(6, 4), torch.zeros(6, 4)), topt)


@pytest.mark.parametrize("name,V", [("1f1b", 1), ("interleaved", 2)])
def test_one_stage_mesh_runs_in_this_process(name, V):
    """A ``pp1`` mesh needs no group: the one rank is its own neighbour
    (what it sends it keeps), against the JAX executor on one device."""
    stages, head, x, y = _toy(V, 5)
    want = _np(JS.spmd_pipeline_train(
        _stack(stages, 1, V, jnp.asarray),
        {k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(x),
        jnp.asarray(y), _jblock, _jhead, _jax_mesh([1], ["pp"]),
        schedule=name, n_microbatches=M, num_virtual=V))
    got = W._numpy(TS.spmd_pipeline_train(
        _stack(stages, 1, V, torch.from_numpy),
        {k: torch.from_numpy(v) for k, v in head.items()},
        torch.from_numpy(x), torch.from_numpy(y), W.toy_block,
        W.toy_head_loss, ProcessMesh(shape=[1], dim_names=["pp"]),
        schedule=name, n_microbatches=M, num_virtual=V))
    assert abs(float(got[0]) - float(want[0])) < 1e-5
    for k in ("w", "b"):
        np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-5)
    np.testing.assert_allclose(got[2]["wo"], want[2]["wo"], atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)
    assert TS.last_stats()["p2p"]["calls"] == 0
