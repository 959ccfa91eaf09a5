"""The port's ``fsdp`` axis (ZeRO-3) in ``ShardedTrainStep`` and
``group_sharded_parallel`` on the CPU against the JAX package
(``paddlepaddle_tpu/parallel/sharded.py`` :87-216,
``distributed/sharding/__init__.py`` :30-71, ``tests/test_llama.py:57``,
``tests/test_generate_sharding.py:37-66``).

The reference's ZeRO-3 is its ``ShardedTrainStep`` over a mesh with a
parameter-sharding axis: the rules (or ``p_g_os``'s placements) shard the
parameters over ``fsdp``, and XLA gathers them where they are used. The
port's ranks hold their shards and gather each where its module uses it;
the gather's backward reduce-scatters the gradient over a data axis and
takes the rank's slice over an axis the batch is not sharded over.

Each case trains the reference test's tiny Llama (vocab 64, hidden 32, two
layers, 4 heads, 2 KV heads) from the JAX model's initial weights for three
AdamW steps (lr 1e-3, global-norm clip 0.5; ``p_g_os`` below) on one
global batch whose row 1
is partly masked (``-100``), so the data ranks hold different counts of
valid tokens. Meshes: ``fsdp2``, ``dp2fsdp2``, ``fsdp2mp2``, ``[1, 2, 2]``
``dp/fsdp/tp`` (the Llama table's own ``tp``), the ``p_g_os`` arm over
``dp2fsdp2`` with ``data_axes=("dp",)`` (the reference test's text: every
parameter's largest dim on ``fsdp``, the batch on ``dp`` alone), and C21's
two probes: ``[1, 2]`` ``dp/tp`` and ``[1, 1, 1]`` ``dp/fsdp/tp`` (one
rank). Each runs in both forms of the port's step: SPMD (gloo ranks from
the port's ``spawn``; rank body ``tests/torch_dist_workers.py:
fsdp_session``) and single-process (this process is rank 0 and the step
starts the others), but ``[1, 2, 2]`` SPMD alone and the one-rank probe
in its one form:

* losses against the JAX ``ShardedTrainStep`` over the same mesh, rules
  and data axes at rtol 1e-5;
* every parameter after the steps (``full_params``) against the JAX step's
  at 1e-4 absolute;
* the local shards' shapes (each matrix a quarter or a half);
* ``p_g_os``: momentum SGD (lr 0.05, no clip), so the gradients' scale
  shows; the same ``dist_spec`` by name as the JAX package, and
  ``save_group_sharded_model`` writes the whole parameters and the whole
  optimizer state.

The tiny MoE (``MoEConfig.tiny()``, sorted and fused dispatch) on
``dp2fsdp2`` under ``moe_sharding_rules()`` (the trunk on ``fsdp``, the
banks whole) against the port's one-process ``TrainStep``: losses rtol
1e-5, parameters 1e-4.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
from paddlepaddle_tpu.distributed.sharding import \
    group_sharded_parallel as jgroup_sharded
from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu.models.llama import llama_sharding_rules as jllama
from paddlepaddle_tpu.optimizer import AdamW as JAdamW
from paddlepaddle_tpu.optimizer import Momentum as JMomentum
from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import spawn
from paddlepaddle_tpu_torch.distributed.sharding import \
    save_group_sharded_model
from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules

STEPS, LR, CLIP = 3, 1e-3, 0.5
# p_g_os trains with momentum, which, unlike Adam after a global-norm clip,
# moves with the gradients' scale: a backward that summed the equal
# gradients over fsdp (a data axis it is not) would move twice as far
MOMENTUM_LR = 0.05
REPLICATE = [(r".*", ())]
# name: (mesh shape, axis names, rules kind, data axes, p_g_os)
CASES = {
    "fsdp2": ([2], ["fsdp"], "tp", ("dp", "fsdp"), False),
    "dp2fsdp2": ([2, 2], ["dp", "fsdp"], "tp", ("dp", "fsdp"), False),
    "fsdp2mp2": ([2, 2], ["fsdp", "mp"], "mp", ("dp", "fsdp"), False),
    "dp1fsdp2tp2": ([1, 2, 2], ["dp", "fsdp", "tp"], "tp", ("dp", "fsdp"),
                    False),
    "p_g_os": ([2, 2], ["dp", "fsdp"], "none", ("dp",), True),
    "c21_dp1tp2": ([1, 2], ["dp", "tp"], "tp", ("dp", "fsdp"), False),
    "c21_one_rank": ([1, 1, 1], ["dp", "fsdp", "tp"], "tp", ("dp", "fsdp"),
                     False),
}
# the reference's texts, the acceptance meshes and C21's two-rank probe in
# both forms; [1, 2, 2] in the SPMD form alone (the forms share every line
# of the step past the ranks' start); one rank has one form
RUNS = [(name, form) for name in ("fsdp2", "dp2fsdp2", "fsdp2mp2", "p_g_os",
                                  "c21_dp1tp2")
        for form in ("spmd", "single")] + [
    ("dp1fsdp2tp2", "spmd"), ("c21_one_rank", "single")]


def _rules(kind, pkg_rules):
    return REPLICATE if kind == "none" else pkg_rules(tp_axis=kind)


def _batch():
    ids = np.random.default_rng(2).integers(0, 64, (4, 16)).astype(np.int32)
    labels = ids.copy()
    labels[1, :11] = -100
    return ids, labels


def _jax_case(name):
    shape, names, kind, data_axes, p_g_os = CASES[name]
    ids, labels = _batch()
    paddle.seed(11)
    m = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                          layers=2, heads=4, kv_heads=2,
                                          max_len=64))
    state = {k: np.asarray(v).astype(np.float32)
             for k, v in m.functional_state().items()
             if k not in ("model.rope_cos", "model.rope_sin")}
    if p_g_os:
        opt = JMomentum(learning_rate=MOMENTUM_LR, momentum=0.9,
                        parameters=m.parameters())
    else:
        opt = JAdamW(learning_rate=LR, parameters=m.parameters(),
                     grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    specs = None
    if p_g_os:
        m, opt, _ = jgroup_sharded(m, opt, level="p_g_os")
        specs = {n: p.dist_spec for n, p in m.named_parameters()}
    step = JStep(m, opt, lambda mm, i, l: mm(i, labels=l),
                 mesh=JMesh(shape=shape, dim_names=names),
                 rules=_rules(kind, jllama), data_axes=data_axes)
    losses = [float(step(ids, labels).numpy()) for _ in range(STEPS)]
    params = {n: np.asarray(v) for n, v in step.params.items()}
    case = {"state": state, "shape": shape, "names": names,
            "rules": _rules(kind, llama_sharding_rules),
            "data_axes": data_axes, "p_g_os": p_g_os, "clip": CLIP,
            "opt": "momentum" if p_g_os else "adamw",
            "lr": MOMENTUM_LR if p_g_os else LR}
    return case, {"losses": losses, "params": params, "specs": specs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in the JAX package and in both forms of the port's step;
    the ``p_g_os`` arm's files from ``save_group_sharded_model``."""
    ids, labels = _batch()
    cases, ref = {}, {}
    for name in CASES:
        cases[name], ref[name] = _jax_case(name)
    by_ranks = {}
    for name, form in RUNS:
        if form == "spmd":
            n = int(np.prod(cases[name]["shape"]))
            by_ranks.setdefault(n, {})[name] = cases[name]
    spmd = {}
    for n, group in by_ranks.items():
        spmd.update(spawn(W.fsdp_session,
                          args=(group, ids.astype(np.int64),
                                labels.astype(np.int64), STEPS),
                          nprocs=n, timeout=300, pg_timeout=120)[0])
    single, extra = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in [n for n, f in RUNS if f == "single"]:
            case = cases[name]
            model, step = W.fsdp_case_step(case)
            try:
                single[name] = W.fsdp_run(step, ids.astype(np.int64),
                                          labels.astype(np.int64), STEPS)
                if case["p_g_os"]:
                    out = tmp_path_factory.mktemp("p_g_os")
                    save_group_sharded_model(model, str(out),
                                             step.optimizer)
                    extra = {
                        "specs": {n: p.dist_spec
                                  for n, p in model.named_parameters()},
                        "saved": pickle.loads(
                            (out / "model.pdmodel").read_bytes()),
                        "saved_opt": pickle.loads(
                            (out / "model.pdopt").read_bytes()),
                        "opt_shapes": {n: tuple(p.shape) for n, p in
                                       step.params.items()}}
                single[name]["workers"] = (
                    None if step.workers is None
                    else len(step.workers.procs))
            finally:
                step.close()
    finally:
        torch.set_num_threads(threads)
    return ref, {"spmd": spmd, "single": single}, extra


@pytest.mark.parametrize("name,form", RUNS)
def test_losses_match_the_reference_sharded_step(runs, name, form):
    ref, got, _ = runs
    np.testing.assert_allclose(got[form][name]["losses"],
                               ref[name]["losses"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,form", RUNS)
def test_parameters_match_the_reference_sharded_step(runs, name, form):
    ref, got, _ = runs
    want = ref[name]["params"]
    params = got[form][name]["params"]
    assert set(params) == set(want)
    for n, p in params.items():
        np.testing.assert_allclose(p, want[n], atol=1e-4, err_msg=n)


def test_local_shards_are_the_plan_blocks(runs):
    _, got, _ = runs
    shapes = {name: got[form][name]["shapes"] for name, form in RUNS}
    q = "model.layers.0.self_attn.q_proj.weight"
    o = "model.layers.0.self_attn.o_proj.weight"
    emb = "model.embed_tokens.weight"
    assert shapes["fsdp2"][q] == (16, 32) and shapes["fsdp2"][o] == (32, 16)
    assert shapes["dp2fsdp2"][q] == (16, 32)
    assert shapes["fsdp2mp2"][q] == (16, 16)
    assert shapes["fsdp2mp2"][emb] == (32, 16)
    assert shapes["dp1fsdp2tp2"][q] == (16, 16)
    assert shapes["c21_dp1tp2"][q] == (32, 16)
    assert shapes["c21_one_rank"][q] == (32, 32)
    for name in CASES:
        assert shapes[name]["model.norm.weight"] in ((32,), (16,))
    assert got["spmd"]["fsdp2"]["shapes"] == got["single"]["fsdp2"]["shapes"]
    # p_g_os shards the norms too: each parameter's largest dim
    assert shapes["p_g_os"]["model.norm.weight"] == (16,)
    assert shapes["p_g_os"]["lm_head.weight"] == (32, 32)
    assert got["single"]["c21_one_rank"]["workers"] is None
    assert got["single"]["fsdp2mp2"]["workers"] == 3


def test_p_g_os_marks_the_reference_dist_specs_and_saves_whole(runs):
    ref, got, extra = runs
    want = ref["p_g_os"]["specs"]
    assert extra["specs"] == want
    assert want["model.layers.0.self_attn.q_proj.weight"] == ("fsdp", None)
    full = got["single"]["p_g_os"]["params"]
    assert set(extra["saved"]) == set(full)
    for n, p in full.items():
        np.testing.assert_array_equal(extra["saved"][n], p)
    opt = extra["saved_opt"]
    assert opt["@step"] == STEPS
    for n, p in full.items():
        assert opt[f"{n}_velocity"].shape == p.shape, n
    assert extra["opt_shapes"]["model.norm.weight"] == (16,)


def test_group_sharded_parallel_levels_and_a_bad_level():
    m = W.port_llama(_jax_case_state(), "float32", W.FSDP_CFG)
    opt = pt.AdamW(parameters=m.parameters())
    from paddlepaddle_tpu_torch.distributed.sharding import \
        group_sharded_parallel

    for level in ("os", "os_g"):
        m2, opt2, sc = group_sharded_parallel(m, opt, level)
        assert (m2, opt2, sc) == (m, opt, None)
        assert m._group_sharded_level == opt._group_sharded_level == level
        assert all(getattr(p, "dist_spec", None) is None
                   for p in m.parameters())
    with pytest.raises(ValueError, match="level"):
        group_sharded_parallel(m, opt, level="bogus")


def _jax_case_state():
    paddle.seed(11)
    m = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                          layers=2, heads=4, kv_heads=2,
                                          max_len=64))
    return {k: np.asarray(v).astype(np.float32)
            for k, v in m.functional_state().items()
            if k not in ("model.rope_cos", "model.rope_sin")}


@pytest.mark.parametrize("mode", ["sorted", "fused"])
def test_moe_on_dp2fsdp2_matches_one_process(mode):
    """The MoE's routing gathers over the data group (dp x fsdp), its
    trunk's matrices are gathered over fsdp, its banks stay whole."""
    from paddlepaddle_tpu.models.moe import MoEConfig, MoEForCausalLM

    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep
    from paddlepaddle_tpu_torch.parallel.moe import moe_sharding_rules

    paddle.seed(7)
    jm = MoEForCausalLM(dataclasses.replace(MoEConfig.tiny(),
                                            dispatch_mode=mode))
    state = {k: np.asarray(v).copy() for k, v in
             jm.functional_state().items()}
    cf = MoEConfig.tiny().capacity_factor
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 16)))

    def opt(m):
        return pt.AdamW(learning_rate=LR, parameters=m.parameters(),
                        grad_clip=pt.ClipGradByGlobalNorm(CLIP))

    one = W.port_moe(state, mode, cf)
    s1 = pt.TrainStep(one, opt(one), lambda m, i, l: m(i, labels=l),
                      device="cpu")
    want = [float(s1(ids, ids)) for _ in range(2)]
    model = W.port_moe(state, mode, cf)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    step = ShardedTrainStep(model, opt(model),
                            lambda m, i, l: m(i, labels=l),
                            mesh=ProcessMesh(shape=[2, 2],
                                             dim_names=["dp", "fsdp"]),
                            rules=moe_sharding_rules())
    try:
        got = [float(step(ids, ids)) for _ in range(2)]
        full = step.full_params()
        bank = tuple(step.params["layers.0.mlp.w_gate_proj"].shape)
        q = tuple(step.params["layers.0.self_attn.q_proj.weight"].shape)
    finally:
        step.close()
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert bank[0] == MoEConfig.tiny().num_experts and q[0] == 16
    for n, p in one.named_parameters():
        np.testing.assert_allclose(full[n].numpy(), p.detach().numpy(),
                                   atol=1e-4, err_msg=n)
