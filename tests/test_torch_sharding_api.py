"""The port's auto-parallel API on the CPU against the JAX package
(``paddlepaddle_tpu/distributed/sharding_api.py`` :24-136,
``distributed/auto_parallel/__init__.py`` :34-258).

The reference's dist tensor is an array whose value is global; the port's
is a ``torch.distributed.tensor.DTensor`` over the mesh's ranks, so the
multi-rank cases run on two gloo ranks from the port's ``spawn`` (rank body
``tests/torch_dist_workers.py:sharding_api_session``) and the JAX side on
two of its eight virtual CPU devices:

* ``shard_tensor`` then ``reshard`` for every pair of ``Replicate``,
  ``Shard(0)`` and ``Shard(1)`` over a two-rank mesh, and ``Partial`` ->
  ``Replicate``: the global value equals ``np.asarray`` of the JAX result,
  exactly, and ``dist_attr`` names the same mesh and placements; each
  rank's block is its slice of the global value; resharding to a
  ``Partial`` raises ``NotImplementedError`` in both;
* ``placements_to_spec`` against the reference's over one- and
  two-dimensional meshes;
* ``shard_layer``'s default (every parameter replicated): the output of a
  Linear on the JAX Linear's weights within 1e-6;
* ``parallelize``: the same ``dist_spec`` by name on the Llama, the
  same refusal of a pattern that matches no sublayer, and a
  ``SequenceParallelBegin`` that applies and marks what follows it;
* ``DistModel`` (``to_static``) on ``fsdp2`` with the Llama table, in
  train, eval and predict mode, against the JAX ``DistModel``: losses at
  rtol 1e-5, logits within 1e-4; ``shard_dataloader`` yields the JAX
  loader's values.
"""

import pickle

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.distributed as JD
from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu.models.llama import llama_sharding_rules as jllama
from paddlepaddle_tpu.optimizer import AdamW as JAdamW

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
import paddlepaddle_tpu_torch.distributed as D
from paddlepaddle_tpu_torch.distributed import spawn
from paddlepaddle_tpu_torch.distributed import sharding_api as tsa
from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules

PAIRS = [(a, b) for a in ("R", "S0", "S1") for b in ("R", "S0", "S1")]


def _enc(k):
    return ("R",) if k == "R" else ("S", int(k[1]))


def _jplace(k, pkg=JD):
    return pkg.Replicate() if k == "R" else pkg.Shard(int(k[1]))


def _x():
    return np.random.default_rng(4).standard_normal((4, 6)).astype(
        np.float32)


@pytest.fixture(scope="module")
def api():
    x = _x()
    rng = np.random.default_rng(5)
    layer = {"weight": rng.standard_normal((6, 3)).astype(np.float32),
             "bias": rng.standard_normal((3,)).astype(np.float32)}
    pairs = [([2], ["x"], [_enc(a)], [_enc(b)]) for a, b in PAIRS]
    pairs.append(([2], ["x"], [("P", "sum")], [("R",)]))
    ranks = spawn(W.sharding_api_session, args=(x, pairs, layer), nprocs=2,
                  timeout=240, pg_timeout=120)
    return x, layer, ranks


def _jax_pair(x, src, dst):
    mesh = JD.ProcessMesh(shape=[2], dim_names=["x"])
    a = JD.shard_tensor(paddle.to_tensor(x), mesh, src)
    b = JD.reshard(a, mesh, dst)
    return np.asarray(b.numpy()), JD.sharding_api.dist_attr(b)


@pytest.mark.parametrize("i", range(len(PAIRS) + 1))
def test_shard_then_reshard_matches_the_reference(api, i):
    x, _, ranks = api
    if i < len(PAIRS):
        src, dst = ([_jplace(k)] for k in PAIRS[i])
    else:
        src, dst = [JD.Partial("sum")], [JD.Replicate()]
    want, (jmesh, jplace) = _jax_pair(x, src, dst)
    for r in ranks:
        got = r["pairs"][i]
        np.testing.assert_array_equal(got["src_global"], x)
        np.testing.assert_array_equal(got["global"], want)
        assert got["mesh"] == (jmesh.shape, jmesh.dim_names)
        assert got["placements"] == [repr(p) for p in jplace]
        d = dst[0]
        block = (want if isinstance(d, JD.Replicate)
                 else np.split(want, 2, axis=d.get_dim())[r["rank"]])
        np.testing.assert_array_equal(got["local"], block)


def test_reshard_to_partial_raises_in_both():
    mesh = JD.ProcessMesh(shape=[1], dim_names=["x"])
    with pytest.raises(NotImplementedError):
        JD.reshard(JD.shard_tensor(paddle.to_tensor(_x()), mesh,
                                   [JD.Replicate()]), mesh, [JD.Partial()])
    tmesh = D.ProcessMesh(shape=[1], dim_names=["x"])
    t = D.shard_tensor(torch.from_numpy(_x()), tmesh, [D.Replicate()])
    np.testing.assert_array_equal(t.numpy(), _x())
    assert D.dist_attr(t)[1] == [D.Replicate()]
    with pytest.raises(NotImplementedError):
        D.reshard(t, tmesh, [D.Partial()])
    with pytest.raises(RuntimeError, match="distributed.launch"):
        D.shard_tensor(torch.from_numpy(_x()),
                       D.ProcessMesh(shape=[2], dim_names=["x"]),
                       [D.Shard(0)])


@pytest.mark.parametrize("shape,names,places", [
    ([2], ["x"], ["S1"]), ([2, 2], ["a", "b"], ["S0", "S1"]),
    ([2, 2], ["a", "b"], ["S0", "S0"]), ([2, 2], ["a", "b"], ["R", "S1"]),
    ([2, 2], ["a", "b"], ["P", "S0"])])
def test_placements_to_spec_matches_the_reference(shape, names, places):
    from paddlepaddle_tpu.distributed.sharding_api import \
        placements_to_spec as jspec

    def mk(pkg):
        return [pkg.Partial() if k == "P" else _jplace(k, pkg)
                for k in places]

    want = jspec(JD.ProcessMesh(shape=shape, dim_names=names), mk(JD), 3)
    got = tsa.placements_to_spec(D.ProcessMesh(shape=shape, dim_names=names),
                                 mk(D), 3)
    assert got == tuple(want)


def test_shard_layer_default_replicates_like_the_reference(api):
    x, layer, ranks = api
    lin = paddle.nn.Linear(6, 3)
    lin.weight.set_value(layer["weight"])
    lin.bias.set_value(layer["bias"])
    mesh = JD.ProcessMesh(shape=[2], dim_names=["x"])
    JD.shard_layer(lin, mesh)
    want = np.asarray(lin(JD.shard_tensor(paddle.to_tensor(x), mesh,
                                          [JD.Replicate()])).numpy())
    for r in ranks:
        np.testing.assert_allclose(r["layer_out"], want, atol=1e-6)
        assert r["layer_attrs"] == {"weight": ["Replicate()"],
                                    "bias": ["Replicate()"]}


def _jax_llama(seed=3):
    paddle.seed(seed)
    return LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                             layers=2, heads=4, kv_heads=2,
                                             max_len=64))


def _state(m):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in m.functional_state().items()
            if k not in ("model.rope_cos", "model.rope_sin")}


def test_parallelize_marks_the_reference_specs():
    def plan(pkg):
        return {"mp_config": {"parallelize_plan": {
            "embed_tokens": pkg.RowWiseParallel(),
            r"model\.layers\.\d+\.self_attn\.(q|k|v)_proj":
                pkg.ColWiseParallel(),
            "o_proj": pkg.RowWiseParallel(),
            "lm_head": [pkg.ColWiseParallel(gather_output=True)]}}}

    jm = _jax_llama()
    JD.parallelize(jm, config=plan(JD))
    tm = W.port_llama(_state(jm), "float32", W.FSDP_CFG)
    model, opt = D.parallelize(tm, pt.AdamW(parameters=tm.parameters()),
                               config=plan(D))
    want = {n: getattr(p, "dist_spec", None)
            for n, p in jm.named_parameters()}
    got = {n: getattr(p, "dist_spec", None)
           for n, p in model.named_parameters()}
    assert got == want
    assert got["model.layers.1.self_attn.k_proj.weight"] == (None, "mp")
    for pkg, m in ((JD, jm), (D, tm)):
        with pytest.raises(ValueError, match="matched no sublayer"):
            pkg.parallelize(m, config={"mp_config": {"parallelize_plan": {
                "no_such_layer": pkg.ColWiseParallel()}}})
    # sequence parallelism applies as the reference's does (its values:
    # tests/test_torch_sequence_parallel.py): the layers between a Begin
    # and the model's end are marked, and no placement changes
    for pkg, m in ((JD, jm), (D, tm)):
        pkg.parallelize(m, config={"mp_config": {"parallelize_plan": {
            r"model\.layers\.1\.self_attn\.o_proj":
                pkg.auto_parallel.SequenceParallelBegin()}}})
    assert {n: getattr(p, "dist_spec", None)
            for n, p in model.named_parameters()} == want
    assert tm.model.layers[1].self_attn.o_proj._sp_begin == "mp"
    assert getattr(tm.model.norm.weight, "sequence_parallel", False)
    assert not getattr(tm.model.layers[0].input_layernorm.weight,
                       "sequence_parallel", False)


def test_dist_model_train_eval_predict_match_the_reference():
    ids = np.random.default_rng(6).integers(0, 64, (4, 16)).astype(
        np.int32)
    jm = _jax_llama(seed=8)
    state = _state(jm)
    jmesh = JD.ProcessMesh(shape=[2], dim_names=["fsdp"])
    jdm = JD.to_static(jm, None, LlamaForCausalLM.loss_from_logits,
                       JAdamW(learning_rate=1e-3,
                              parameters=jm.parameters()),
                       mesh=jmesh, rules=jllama())
    want = [float(jdm(ids, ids).numpy()) for _ in range(2)]
    jdm.eval()
    want_eval = float(jdm(ids, ids).numpy())
    jdm.predict()
    want_logits = np.asarray(jdm(ids).numpy())

    tm = W.port_llama(state, "float32", W.FSDP_CFG)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dm = D.to_static(tm, None, pt.LlamaForCausalLM.loss_from_logits,
                     pt.AdamW(learning_rate=1e-3, parameters=tm.parameters()),
                     mesh=D.ProcessMesh(shape=[2], dim_names=["fsdp"]),
                     rules=llama_sharding_rules())
    try:
        ids_t = torch.from_numpy(ids).long()
        got = [float(dm(ids_t, ids_t)) for _ in range(2)]
        q = dm._step.params["model.layers.0.self_attn.q_proj.weight"]
        assert tuple(q.shape) == (16, 32)
        dm.eval()
        got_eval = float(dm(ids_t, ids_t))
        dm.predict()
        got_logits = dm(ids_t).numpy()
        sd = dm.state_dict()
    finally:
        dm.close()
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-5)
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4)
    np.testing.assert_array_equal(
        sd["model.norm.weight"].numpy(),
        dict(tm.named_parameters())["model.norm.weight"].detach().numpy())


def test_shard_dataloader_yields_the_reference_values():
    rng = np.random.default_rng(9)
    batches = [[rng.integers(0, 64, (4, 8)).astype(np.int64),
                rng.standard_normal((4,)).astype(np.float32)]
               for _ in range(3)]
    jl = JD.shard_dataloader(batches, JD.ProcessMesh(shape=[2],
                                                      dim_names=["dp"]))
    tl = D.shard_dataloader(batches, D.ProcessMesh(shape=[2],
                                                   dim_names=["dp"]))
    assert len(tl) == len(jl) == 3
    for jb, tb in zip(jl, tl):
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))


# -- C22: save_group_sharded_model writes the reference's whole files ---------


def _c22_models():
    """The JAX and port ``Linear(4, 4)`` + ``BatchNorm1D(4)`` on the same
    weights and running statistics (seeded, so the buffers carry values),
    in eval mode (the JAX step never updates the statistics), each with
    ``AdamW`` over ``StepDecay(0.1, step_size=2)``."""
    paddle.seed(3)
    jm = paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                              paddle.nn.BatchNorm1D(4))
    rng = np.random.default_rng(6)
    state = {k: np.asarray(v.numpy()).copy()
             for k, v in jm.state_dict().items()}
    state["1._mean"] = rng.standard_normal(4).astype(np.float32)
    state["1._variance"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = pt.nn.Sequential(pt.nn.Linear(4, 4, device="cpu"),
                          pt.nn.BatchNorm1D(4, device="cpu"))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jm.eval()
    tm.eval()
    jsched = paddle.optimizer.lr.StepDecay(0.1, step_size=2)
    tsched = pt.optimizer.lr.StepDecay(0.1, step_size=2)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters())
    topt = pt.AdamW(learning_rate=tsched,
                    parameters=tm.named_parameters())
    return jm, tm, jsched, tsched, jopt, topt


def _c22_loss(m, x):
    return (m(x) ** 2).mean()


def _c22_files(save, model, opt, out):
    save(model, str(out), opt)
    return (pickle.loads((out / "model.pdmodel").read_bytes()),
            pickle.loads((out / "model.pdopt").read_bytes()))


def _jax_files(model, opt, out):
    from paddlepaddle_tpu.distributed.sharding import \
        save_group_sharded_model as jsave
    from paddlepaddle_tpu.framework.io_api import load

    jsave(model, str(out), opt)
    return (load(str(out / "model.pdmodel"), return_numpy=True),
            load(str(out / "model.pdopt"), return_numpy=True))


@pytest.mark.parametrize("stepped", [False, True])
def test_c22_saved_files_hold_what_the_reference_saves(tmp_path, stepped):
    """The model's buffers (BatchNorm's ``_mean`` / ``_variance``) and the
    optimizer's ``LR_Scheduler`` are in the files, with the reference's
    keys and values: with no step taken, and after one step of a
    single-process ``fsdp2`` ``ShardedTrainStep`` (the first weight
    sharded over ``fsdp``; its gather, the buffers and the scheduler's
    state come back through the step)."""
    from paddlepaddle_tpu_torch.distributed.shard_plan import ShardingPlan
    from paddlepaddle_tpu_torch.distributed.sharding import \
        save_group_sharded_model as tsave
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    jm, tm, jsched, tsched, jopt, topt = _c22_models()
    step = None
    if stepped:
        x = np.random.default_rng(8).standard_normal((8, 4)).astype(
            np.float32)
        loss = _c22_loss(jm, paddle.to_tensor(x))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        step = ShardedTrainStep(tm, topt, _c22_loss, plan=ShardingPlan(
            "fsdp2", rules=[(r"0\.weight$", ("fsdp", None)), (r".*", ())],
            data_axes=("dp",)))
        try:
            assert step.workers is not None
            assert tuple(step.params["0.weight"].shape) == (2, 4)
            got = float(step(torch.from_numpy(x)))
            np.testing.assert_allclose(got, float(loss.numpy()), rtol=1e-6)
            tsched.step()
            tfiles = _c22_files(tsave, tm, topt, tmp_path / "port")
        finally:
            step.close()
            torch.set_num_threads(threads)
    else:
        tfiles = _c22_files(tsave, tm, topt, tmp_path / "port")
    jmodel, jopt_state = _jax_files(jm, jopt, tmp_path / "jax")
    tmodel, topt_state = tfiles
    assert list(tmodel) == list(jmodel)
    assert {"1._mean", "1._variance"} <= set(tmodel)
    for k, v in jmodel.items():
        np.testing.assert_allclose(tmodel[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the reference names slots by its parameters' generated names; the
    # port by the parameters' structured names
    names = dict(zip([p.name for p in jm.parameters()],
                     [n for n, _ in tm.named_parameters()]))
    want = {}
    for k, v in jopt_state.items():
        for jn, tn in names.items():
            if k.startswith(jn + "_"):
                k = tn + k[len(jn):]
                break
        want[k] = v
    assert set(topt_state) == set(want)
    assert topt_state["LR_Scheduler"] == want["LR_Scheduler"]
    assert topt_state["@step"] == want["@step"] == int(stepped)
    assert topt_state["LR_Scheduler"]["last_epoch"] == int(stepped)
    for k, v in want.items():
        if k not in ("LR_Scheduler", "@step"):
            np.testing.assert_allclose(topt_state[k], np.asarray(v),
                                       rtol=1e-6, atol=1e-8, err_msg=k)
    assert len(want) == (2 + 16 * stepped)
