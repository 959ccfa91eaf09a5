"""The port's sharding plan and tensor-parallel decode on the CPU against
the JAX package (``paddlepaddle_tpu/distributed/shard_plan.py``,
``tests/test_shard_plan.py``).

* Plan units against the JAX plan: spec parsing and its errors, rule
  resolution for every Llama parameter name and shape under the decode and
  train tables, ``validate_divisible``, ``describe``, and each rank's local
  shard against the matching addressable shard of the JAX-placed array
  (also ``QuantizedWeight``'s ``q`` and scales, the KV pool and the
  batch), all exact.
* TP-2 decode, two gloo ranks from the port's ``spawn`` (rank bodies in
  ``tests/torch_dist_workers.py``, which imports no JAX) on the reference
  test's fixed workload (``tests/test_shard_plan.py:199-217``): greedy
  tokens equal the JAX ``decode_plan("mp2")`` engine's and the port's
  one-process engine's, in f32 (also at 2 KV heads a rank), in bf16 and
  with int8 weights; first-step
  logits within 1e-5 (f32) and 2e-2 (bf16: two rounding orders of the
  row-parallel sums, each partial rounded to bf16 before the all-reduce)
  of the one-process model; prefix hits under TP; the local KV pool;
  ``ServingEngine(mesh="mp2")``'s health and gauges; a follower that
  fails alone failing the driver at once.
* The refusals: ``sp`` and ``pp`` axes (``ep`` and ``fsdp`` build, with
  ``moe_train_rules`` and the Llama training table, and refuse serving),
  ``require_group`` on a multi-rank plan
  without a process group, ``kv_quant`` with a plan, static mode with a
  mesh; a multi-rank plan without a group serving, training in one process
  (``ShardedTrainStep``'s single-process form, held against the JAX
  package in ``tests/test_torch_sharded_single.py``), and speculative
  decoding under a plan serving (their single-process form is held
  against the JAX package in ``tests/test_torch_tp_engine.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed import shard_plan as jsp
from paddlepaddle_tpu.inference.decode_engine import \
    BatchDecodeEngine as JaxEngine
from paddlepaddle_tpu.inference.serving import \
    GenerationRequest as JaxRequest
from paddlepaddle_tpu.models import LlamaConfig as JaxConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JaxLlama

import torch_dist_workers as W
from paddlepaddle_tpu_torch.distributed import shard_plan as tsp
from paddlepaddle_tpu_torch.distributed import spawn

SKIP = ("model.rope_cos", "model.rope_sin")


def _jax_tiny(dtype, seed=0, cfg=None):
    paddle.seed(seed)
    return JaxLlama(JaxConfig(**dict(cfg or W.TINY, dtype=dtype)))


def _state_f32(model):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in model.functional_state().items() if k not in SKIP}


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 128, (int(n),)).astype(np.int32)
            for n in (9, 17, 25)]


def _pfx_prompts():
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, 128, (20,)).astype(np.int32)
    tails = [rng.integers(0, 128, (7,)).astype(np.int32) for _ in range(3)]
    return [np.concatenate([sysp, t]) for t in tails]


def _jax_serve(model, prompts, n, quant=None, prefix_len=None):
    eng = JaxEngine(model, max_slots=2, chunk=4, page_size=16,
                    plan=jsp.decode_plan("mp2"), quant=quant)
    reqs = [JaxRequest(p, n, 0.0, 0, None, prefix_len=prefix_len)
            for p in prompts]
    eng.serve(reqs, timeout=300)
    return [np.asarray(r.result.result(5)) for r in reqs]


@pytest.fixture(scope="module")
def jax_models():
    models = {d: _jax_tiny(d) for d in ("float32", "bfloat16")}
    models["gqa"] = _jax_tiny("float32", cfg=W.TINY_GQA)
    return models


@pytest.fixture(scope="module")
def session(jax_models):
    states = {d: _state_f32(m) for d, m in jax_models.items()}
    return spawn(W.decode_session, args=(states, _prompts(), _pfx_prompts()),
                 nprocs=2, timeout=280, pg_timeout=120)


# -- plan units against the JAX plan ------------------------------------------

@pytest.mark.parametrize("spec", ["dp2mp4", "dp2xmp4", "mp2", "fsdp2mp2",
                                  "", "dp", "2dp", "dp2dp4", "dp0",
                                  "dp2 bogus", "dp2x4", "mp2x"])
def test_parse_mesh_spec_matches_reference(spec):
    try:
        want = jsp.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tsp.parse_mesh_spec(spec)
        return
    got = tsp.parse_mesh_spec(spec)
    assert got == want and list(got) == list(want)


def test_mesh_from_spec_matches_reference():
    for spec in ("dp2mp2", "mp2", "dp4mp2"):
        a, b = jsp.mesh_from_spec(spec), tsp.mesh_from_spec(spec)
        assert (a.shape, a.dim_names, a.process_ids) == \
            (b.shape, b.dim_names, b.process_ids)
        for r in b.process_ids:
            for ax in b.dim_names:
                assert b.coords(r)[ax] == \
                    a.get_rank_by_dim_and_process_id(ax, r)


def _plans():
    return [("decode mp2", jsp.decode_plan("mp2"), tsp.decode_plan("mp2")),
            ("decode mp4", jsp.decode_plan("mp4"), tsp.decode_plan("mp4")),
            ("train dp2mp2", jsp.train_plan("dp2mp2", data_axes=("dp",)),
             tsp.train_plan("dp2mp2", data_axes=("dp",))),
            ("train dp4mp2", jsp.train_plan("dp4mp2", data_axes=("dp",)),
             tsp.train_plan("dp4mp2", data_axes=("dp",))),
            ("train dp2", jsp.train_plan("dp2", data_axes=("dp",)),
             tsp.train_plan("dp2", data_axes=("dp",)))]


def test_rule_resolution_matches_reference_for_every_llama_parameter(
        jax_models):
    state = jax_models["float32"].functional_state()
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    shapes["lm_head.weight.odd"] = (64, 127)      # a dim mp does not divide
    checked = 0
    for label, jp, tp in _plans():
        for name, shape in shapes.items():
            want = tuple(jp.spec_for(name, shape))
            assert tp.spec_for(name, shape) == want, (label, name)
            checked += 1
        assert tp.tp_degree == jp.tp_degree and tp.dp_degree == jp.dp_degree
        d, e = tp.describe(), jp.describe()
        assert d.pop("path") == "spmd"
        e.pop("path")
        assert d == e, label
    assert checked > 80


def test_validate_divisible_matches_reference():
    for dims in ({"heads": 4, "kv_heads": 2}, {"kv_heads": 3},
                 {"vocab_size": 127, "heads": 8}):
        for spec in ("mp2", "mp4"):
            outcomes = []
            for mod in (jsp, tsp):
                try:
                    mod.decode_plan(spec).validate_divisible(**dims)
                    outcomes.append(None)
                except ValueError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]


def _addressable(arr):
    """{rank: numpy block} of a JAX-placed array (device id = rank)."""
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("which", [0, 2])
def test_local_shards_equal_jax_addressable_shards(jax_models, which):
    label, jp, tp = _plans()[which]
    state = jax_models["float32"].functional_state()
    placed = jp.shard(state)
    torch_state = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    for rank in range(tp.n_devices):
        mine = tp.shard(torch_state, rank=rank)
        for name, arr in placed.items():
            np.testing.assert_array_equal(
                mine[name].numpy(), _addressable(arr)[rank],
                err_msg=f"{label} {name} rank {rank}")


@pytest.mark.parametrize("group_size", [-1, 16])
def test_quantized_weight_shards_q_and_scales_together(group_size):
    from paddlepaddle_tpu.nn.quant import quantize_param_tree as jq
    from paddlepaddle_tpu_torch.nn.quant import quantize_param_tree as tq

    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    name = "layer.q_proj.weight"
    jqw = jsp.decode_plan("mp2").shard(
        jq({name: jnp.asarray(w)}, group_size=group_size)[0])[name]
    plan = tsp.decode_plan("mp2")
    tqw = tq({name: torch.from_numpy(w)}, group_size=group_size)[0][name]
    for rank in (0, 1):
        mine = plan.shard({name: tqw}, rank=rank)[name]
        np.testing.assert_array_equal(mine.q.numpy(),
                                      _addressable(jqw.q)[rank])
        np.testing.assert_array_equal(mine.scale.numpy(),
                                      _addressable(jqw.scale)[rank])
        assert mine.group_size == group_size


def test_kv_pool_and_batch_placement_match_reference():
    jp, tp = jsp.decode_plan("mp2"), tsp.decode_plan("mp2")
    pool = np.arange(5 * 4 * 2 * 3, dtype=np.float32).reshape(5, 4, 2, 3)
    assert tp.kv_spec(pool.shape) == tuple(jp.kv_spec(pool.shape))
    placed = _addressable(jp.shard_kv(jnp.asarray(pool)))
    for rank in (0, 1):
        np.testing.assert_array_equal(
            tp.shard_kv(torch.from_numpy(pool), rank=rank).numpy(),
            placed[rank])
    jt = jsp.train_plan("dp2mp2", data_axes=("dp",))
    tt = tsp.train_plan("dp2mp2", data_axes=("dp",))
    batch = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    placed = _addressable(jt.shard_batch(jnp.asarray(batch)))
    for rank in range(4):
        np.testing.assert_array_equal(
            tt.shard_batch(torch.from_numpy(batch), rank=rank).numpy(),
            placed[rank])


def test_compile_is_the_one_spmd_path():
    plan = tsp.train_plan("dp2mp2", data_axes=("dp",))
    assert plan.compile_path == "spmd"
    f = lambda a: a * 2  # noqa: E731
    assert plan.compile(f, in_specs=(("dp",),), out_specs=("dp",)) is f
    x = torch.ones(3)
    assert plan.constrain(x, "dp") is x


# -- tensor-parallel decode on two ranks ----------------------------------------

def test_tp2_decode_token_exact_f32(jax_models, session):
    want = _jax_serve(jax_models["float32"], _prompts(), 12)
    tp, one = session[0]["tp_float32"], session[0]["one_float32"]
    for a, b, c in zip(tp, one, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert session[1]["tp_float32"] is None   # the follower delivers nothing
    for r in session:
        assert r["logit_diff_float32"] < 1e-5, r["logit_diff_float32"]


def test_tp2_decode_token_exact_f32_two_kv_heads_a_rank(jax_models,
                                                        session):
    """8 query and 4 KV heads: each rank holds 2 KV heads of 2 query heads
    each, so a KV-head offset or grouping error in the local pool shows."""
    want = _jax_serve(jax_models["gqa"], _prompts(), 12)
    for a, b, c in zip(session[0]["tp_gqa"], session[0]["one_gqa"], want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    for r in session:
        assert r["pool_gqa"] == (13, 16, 2, 8)


def test_tp2_decode_bf16_fixed_workload(jax_models, session):
    want = _jax_serve(jax_models["bfloat16"], _prompts(), 12)
    for a, b, c in zip(session[0]["tp_bfloat16"], session[0]["one_bfloat16"],
                       want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    for r in session:
        assert r["logit_diff_bfloat16"] < 2e-2, r["logit_diff_bfloat16"]


def test_tp2_int8_weights(jax_models, session):
    want = _jax_serve(jax_models["bfloat16"], _prompts(), 12,
                      quant="weight_only_int8")
    for a, b, c in zip(session[0]["tp_int8"], session[0]["one_int8"], want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    for r in session:
        assert r["int8_q_shape"] == (64, 32)      # q columns split over mp


def test_tp_prefix_cache_hits_and_token_parity(jax_models, session):
    want = _jax_serve(jax_models["bfloat16"], _pfx_prompts(), 8,
                      prefix_len=20)
    for a, b, c in zip(session[0]["pfx_True"], session[0]["pfx_False"], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for r in session:
        assert r["pfx_stats_True"] == (2, 1)


def test_tp_kv_pool_is_local_and_cpu_programs_uncaptured(session):
    for r in session:
        # [pages, page_size, kvh / mp, hd]: 2 slots x 6 pages + the null page
        assert r["pool_float32"] == (13, 16, 1, 16)
        assert r["capture_float32"] == {}


def test_serving_engine_mesh_health_and_gauges(jax_models, session):
    """``ServingEngine(mesh="mp2")`` (f32) answers the JAX TP-2 engine's
    greedy tokens, reports the reference's mesh block (the path reads
    ``"spmd"``) and gauges, and drains then stops cleanly."""
    out = session[0]["serving_out"]
    (want,) = _jax_serve(jax_models["float32"],
                         [np.arange(8, dtype=np.int32)], 4)
    assert out.shape == (12,)
    np.testing.assert_array_equal(out, want)
    for r in session:
        h = r["health_mesh"]
        assert h == {"enabled": True, "axes": {"mp": 2}, "devices": 2,
                     "tp": 2, "dp": 1, "path": "spmd"}
        assert r["gauges"]["paddle_tp_degree"][()] == 2
        assert r["gauges"]["paddle_mesh_devices"][(("axes", "mp2"),)] == 2
        assert r["gauges"]["paddle_mesh_axes"][(("axes", "mp2"),)] == 1
        assert r["drain"] is True          # drain, then the with-exit stop


def test_a_follower_that_fails_alone_fails_the_driver_at_once(jax_models,
                                                               tmp_path):
    """An unservable request is failed on its own and both ranks go on; a
    fault on the follower alone ends the follower, and rank 0 raises out of
    ``serve`` well inside the process-group timeout (60 s here)."""
    import json

    state = _state_f32(jax_models["float32"])
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        spawn(W.follower_fault_session,
              args=(state, _prompts()[:1], str(tmp_path)), nprocs=2,
              timeout=120, pg_timeout=60)
    r0 = json.loads((tmp_path / "rank0.json").read_text())
    r1 = json.loads((tmp_path / "rank1.json").read_text())
    assert "exceeds engine max_len" in r0["too_long"]
    assert r1["follower"] == "injected follower fault"
    assert r0["driver"] != "served"
    assert r0["driver_s"] < 30, r0


# -- refusals -------------------------------------------------------------------

def _port_tiny():
    import paddlepaddle_tpu_torch as pt

    return pt.LlamaForCausalLM(pt.LlamaConfig(**W.TINY), device="cpu")


@pytest.mark.parametrize("spec,later", [("ep2", "expert parallelism"),
                                        ("fsdp2mp2", "fsdp"),
                                        ("dp2sp2", "sequence parallel"),
                                        ("pp2", "pipeline")])
def test_axes_outside_dp_mp_raise_naming_the_later_slice(spec, later,
                                                         jax_models):
    """sp (the sequence axis) builds as the reference's plan does: no
    data axis, no parameter-sharding axis, every parameter replicated over
    it; a serving plan over it raises
    (sequence-parallel serving is a later A10 item). ep (expert
    parallelism) and
    fsdp (parameter sharding) are ported for training: their plans build
    with the reference's rule tables and resolve every Llama parameter to
    the reference's spec (the MoE banks on ``ep``; the matrices on
    ``(fsdp, mp)`` / ``(mp, fsdp)``), and a serving plan over either still
    raises. pp (the pipeline axis) builds as the reference's plan does:
    no data axis, every parameter replicated over it; a serving plan over
    it raises (pipeline-parallel serving is a later A10 item)."""
    if spec == "pp2":
        state = jax_models["float32"].functional_state()
        for mesh in ("pp2", "dp2pp2"):
            plan, want = tsp.train_plan(mesh), jsp.train_plan(mesh)
            assert plan.axes == dict(want.axes) == tsp.parse_mesh_spec(mesh)
            assert plan.data_axes == tuple(want.data_axes) == (
                ("dp",) if mesh == "dp2pp2" else ())
            assert plan.dp_degree == want.dp_degree
            assert plan.tp_degree == want.tp_degree == 1
            assert not plan.is_zero_axis("pp")
            for name, v in state.items():
                assert plan.spec_for(name, v.shape) == \
                    tuple(want.spec_for(name, v.shape)) == (), name
        with pytest.raises(NotImplementedError,
                           match="pipeline-parallel serving"):
            tsp.decode_plan(spec)
        return
    if spec == "dp2sp2":
        state = jax_models["float32"].functional_state()
        for mesh in ("sp2", "dp2sp2"):
            plan, want = tsp.train_plan(mesh), jsp.train_plan(mesh)
            assert plan.axes == dict(want.axes) == tsp.parse_mesh_spec(mesh)
            assert plan.data_axes == tuple(want.data_axes) == (
                ("dp",) if mesh == "dp2sp2" else ())
            assert plan.dp_degree == want.dp_degree
            assert not plan.is_zero_axis("sp")
            for name, v in state.items():
                assert plan.spec_for(name, v.shape) == \
                    tuple(want.spec_for(name, v.shape)) == (), name
        with pytest.raises(NotImplementedError,
                           match="sequence-parallel serving"):
            tsp.decode_plan(spec)
        return
    if spec == "ep2":
        plan = tsp.ShardingPlan(spec, rules=tsp.moe_train_rules())
        assert plan.axes == {"ep": 2}
        assert tsp.moe_train_rules() == jsp.moe_train_rules()
        assert plan.spec_for("layers.0.mlp.w_gate_proj",
                             (4, 32, 64)) == ("ep",)
        with pytest.raises(NotImplementedError,
                           match="expert-parallel serving"):
            tsp.decode_plan(spec)
        return
    if spec == "fsdp2mp2":
        plan = tsp.train_plan(spec)
        want = jsp.train_plan(spec)
        assert plan.axes == {"fsdp": 2, "mp": 2}
        assert plan.data_axes == ("fsdp",) and plan.model_axis == "mp"
        assert plan.dp_degree == want.dp_degree == 2
        assert plan.tp_degree == want.tp_degree == 2
        state = jax_models["float32"].functional_state()
        for name, v in state.items():
            assert plan.spec_for(name, v.shape) == \
                tuple(want.spec_for(name, v.shape)), name
        assert plan.spec_for("model.layers.0.self_attn.o_proj.weight",
                             (64, 64)) == ("mp", "fsdp")
        with pytest.raises(NotImplementedError, match=later):
            tsp.decode_plan(spec)
        return
    with pytest.raises(NotImplementedError, match=later):
        tsp.ShardingPlan(spec)


def test_c21_axis_roles_come_from_the_plan_not_the_names(jax_models):
    """C21: the plan refused axis names the reference trains on. The
    Llama table's own ``tp`` is the model axis (the reference's
    ``llama_sharding_rules`` default); size-1 axes drop out, so ``[1, 1,
    1]`` ``dp/fsdp/tp`` is one rank; every parameter resolves to the JAX
    plan's spec. ``ep`` beside a parameter-sharding axis (A10 slice 5)
    builds as the reference's plan: the banks on ``ep``, the trunk on
    ``fsdp``, the data axes the reference's; rules naming two candidate
    model axes ask for
    ``model_axis``. (Training on these meshes against the JAX
    ``ShardedTrainStep``: ``tests/test_torch_fsdp.py`` and
    ``tests/test_torch_ep_fsdp.py``.)"""
    from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
    from paddlepaddle_tpu.models.llama import llama_sharding_rules as jr

    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules
    from paddlepaddle_tpu_torch.parallel.moe import moe_sharding_rules

    state = jax_models["float32"].functional_state()
    for shape, names in (([1, 2], ["dp", "tp"]),
                         ([1, 1, 1], ["dp", "fsdp", "tp"]),
                         ([2, 2], ["fsdp", "tp"])):
        plan = tsp.ShardingPlan(ProcessMesh(shape=shape, dim_names=names),
                                rules=llama_sharding_rules(),
                                data_axes=("dp", "fsdp"))
        want = jsp.ShardingPlan(JMesh(shape=shape, dim_names=names),
                                rules=jr(), data_axes=("dp", "fsdp"))
        for name, v in state.items():
            assert plan.spec_for(name, v.shape) == \
                tuple(want.spec_for(name, v.shape)), (names, name)
        assert plan.model_axis == "tp"
        assert plan.dp_degree == want.dp_degree
        assert plan.data_axes == tuple(a for a, n in zip(names, shape)
                                       if a in ("dp", "fsdp") and n > 1)
    one = tsp.ShardingPlan(ProcessMesh(shape=[1, 1, 1],
                                       dim_names=["dp", "fsdp", "tp"]),
                           rules=llama_sharding_rules())
    assert one.n_devices == 1 and not one.single_process
    assert one.tp_degree == 1 and one.data_axes == ()
    assert tsp.decode_plan("mp2").model_axis == "mp"
    from paddlepaddle_tpu.models.moe import MoEConfig, MoEForCausalLM
    from paddlepaddle_tpu.parallel.moe import moe_sharding_rules as jmr

    moe_state = MoEForCausalLM(MoEConfig.tiny()).functional_state()
    for shape, names, data_axes in (([2, 2], ["fsdp", "ep"], ("fsdp",)),
                                    ([1, 2, 2], ["dp", "fsdp", "ep"],
                                     ("dp", "fsdp"))):
        plan = tsp.ShardingPlan(ProcessMesh(shape=shape, dim_names=names),
                                rules=moe_sharding_rules(),
                                data_axes=data_axes)
        want = jsp.ShardingPlan(JMesh(shape=shape, dim_names=names),
                                rules=jmr(), data_axes=data_axes)
        for name, v in moe_state.items():
            assert plan.spec_for(name, v.shape) == \
                tuple(want.spec_for(name, v.shape)), (names, name)
        assert plan.spec_for("layers.0.mlp.w_gate_proj",
                             (4, 32, 64)) == ("ep",)
        assert plan.data_axes == ("fsdp",) == tuple(
            a for a in want.data_axes if want.axes[a] > 1)
        assert plan.is_zero_axis("fsdp") and not plan.is_zero_axis("ep")
        assert plan.dp_degree == want.dp_degree == 2
    with pytest.raises(ValueError, match="model_axis"):
        tsp.ShardingPlan("dp2", rules=[(r".*q_proj.*", ("a", "b"))])


def test_multi_rank_plan_without_a_group_raises_with_the_launch_command():
    """A multi-rank plan in a process with no group: the decode engine
    serves it in one process (this process is rank 0 and the engine starts
    the other rank), its greedy tokens the one-process engine's, and stops
    its worker; ``ShardedTrainStep`` trains over it in one process too
    (its loss the one-process step's), and ends its worker on ``close()``;
    ``require_group`` on such a plan raises with the launch command."""
    import paddlepaddle_tpu_torch as pt

    model = _port_tiny()
    reqs = W._requests(_prompts(), 6)
    pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                         device="cpu").serve(reqs)
    want = [r.result.result(5) for r in reqs]
    for kw in ({"plan": tsp.decode_plan("mp2")}, {"mesh": "mp2"}):
        eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4,
                                   page_size=16, device="cpu", **kw)
        assert eng.is_driver and eng.mesh_info()["backend"] == "gloo"
        reqs = W._requests(_prompts(), 6)
        eng.serve(reqs)
        eng.stop()
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(r.result.result(5), w)
        assert all(p.exitcode == 0 for p in eng._tp.procs)
    with pytest.raises(RuntimeError, match="distributed.launch"):
        tsp.decode_plan("mp2").require_group()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, W.TINY["vocab_size"], (2, 8)))
    m1 = _port_tiny()
    want = float(pt.TrainStep(m1, pt.AdamW(parameters=m1.parameters()),
                              lambda m, i, l: m(i, labels=l),
                              device="cpu")(ids, ids))
    step = pt.parallel.ShardedTrainStep(
        model, pt.AdamW(parameters=model.parameters()),
        lambda m, i, l: m(i, labels=l),
        plan=tsp.train_plan("dp2", data_axes=("dp",)))
    np.testing.assert_allclose(float(step(ids, ids)), want, rtol=1e-5)
    step.close()
    assert all(p.exitcode == 0 for p in step.workers.procs)


def test_speculative_kv_int8_and_static_mode_refusals_under_a_plan():
    """Speculative decoding under a plan serves (the draft replicated: the
    target as its own draft here) with the plan-less greedy stream; int8
    KV with a plan, static mode with a mesh and a head count the plan does
    not divide stay refused."""
    import paddlepaddle_tpu_torch as pt

    model = _port_tiny()
    outs = []
    for kw in ({}, {"plan": tsp.decode_plan("mp1"), "draft": model,
                    "spec_k": 2}):
        eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4,
                                   page_size=16, device="cpu", **kw)
        reqs = W._requests(_prompts(), 6)
        eng.serve(reqs)
        outs.append([r.result.result(5) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert eng.spec_info()["enabled"] and eng.mesh_info()["tp"] == 1
    with pytest.raises(ValueError, match="kv_quant"):
        pt.BatchDecodeEngine(model, max_slots=2, page_size=16,
                             mesh="mp1", kv_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        pt.ServingEngine(model, mode="static", mesh="mp2", device="cpu")
    bad = pt.LlamaForCausalLM(pt.LlamaConfig(
        vocab_size=64, hidden_size=48, intermediate_size=96,
        num_hidden_layers=1, num_attention_heads=3, num_key_value_heads=3,
        max_position_embeddings=64), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        pt.BatchDecodeEngine(bad, max_slots=2, mesh="mp2", device="cpu")


def test_one_rank_plan_serves_without_a_group():
    """``mp1`` in a plain process: the plan's collectives are identities,
    the tokens are the plan-less engine's, ``mesh_info`` is the plan's."""
    import paddlepaddle_tpu_torch as pt

    model = _port_tiny()
    outs = []
    for kw in ({}, {"mesh": "mp1"}):
        eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4,
                                   page_size=16, device="cpu", **kw)
        reqs = W._requests(_prompts(), 6)
        eng.serve(reqs)
        outs.append([r.result.result(5) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert eng.mesh_info()["tp"] == 1 and eng.is_driver
