"""The port's MoE model under data and expert parallelism on the CPU
against the JAX package (``paddlepaddle_tpu/parallel/moe.py``,
``parallel/sharded.py``, ``tests/test_moe.py:60-85``).

The reference's sharded step is one global jitted function, so its MoE
layer routes the global batch: capacity, drops and the load-balance loss
are the global ones. The port's ranks each hold their rows; its MoE layer
gathers the routing logits over ``dp`` to compute the same decisions.

* Data parallel (``dp2``), every dispatch mode, the tiny MoE at capacity
  factor 0.75 (entries are dropped: asserted), AdamW at lr 1e-3 for two
  steps from the JAX model's initial weights, in both forms of the port's
  step: SPMD (two gloo ranks from the port's ``spawn``; rank body
  ``tests/torch_dist_workers.py:moe_dp_session``) and single-process (this
  process is rank 0 and the step starts rank 1):

  * losses against the JAX ``ShardedTrainStep`` over ``train_plan("dp2")``
    at rtol 1e-5 (the data-parallel sums are the only reordering);
  * the first step's gradients (summed over ``dp``, recorded by
    ``torch_dist_workers.TapAdamW``) against the port's one-process
    autograd gradients at 1e-5 absolute (the same f32 products summed in
    another order);
  * every parameter after the two steps against the port's one-process
    ``TrainStep`` at 1e-4 absolute (a tenth of one step's move; Adam
    amplifies the noise of near-zero gradients, see
    ``tests/test_torch_train.py``).

* A custom gate (one that overrides ``routing()``) under ``dp2`` in one
  process: the layer gathers ``x`` over ``dp`` and routes the global
  batch through it; losses, first gradients and parameters after two
  steps against the port's one-process step with the same gate, at the
  tolerances above.

* Expert parallel: the reference's ``test_moe_expert_parallel_sharded``
  text through the port in one process (eight ranks: ``dp2 x ep4``, the
  banks ``[E/4, ...]`` on each rank), in its two modes and in ``dropless``
  and ``fused``; the five losses against the JAX step's at rtol 1e-5, not
  only falling.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
from paddlepaddle_tpu.distributed.shard_plan import train_plan as jtrain_plan
from paddlepaddle_tpu.models.moe import MoEConfig, MoEForCausalLM
from paddlepaddle_tpu.optimizer import AdamW as JAdamW
from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep
from paddlepaddle_tpu.parallel.moe import moe_sharding_rules as jrules

import torch_dist_workers as W
from paddlepaddle_tpu_torch.distributed import ProcessMesh, spawn, train_plan
from paddlepaddle_tpu_torch.parallel import ShardedTrainStep
from paddlepaddle_tpu_torch.parallel import moe as tmoe
from paddlepaddle_tpu_torch.parallel.moe import moe_sharding_rules

MODES = ("einsum", "sorted", "dropless", "fused")
CF = 0.75          # capacity binds: entries drop in the capacity modes
LR = 1e-3
FORMS = ("spmd", "single")


def _loss(mm, i, l):  # noqa: E741
    return mm(i, labels=l)


def _ids():
    return np.random.default_rng(0).integers(0, 128, (4, 16)).astype(
        np.int32)


def _jax_model(mode, cf):
    paddle.seed(7)
    return MoEForCausalLM(dataclasses.replace(
        MoEConfig.tiny(), dispatch_mode=mode, capacity_factor=cf))


def _state(m):
    return {k: np.asarray(v).copy() for k, v in m.functional_state().items()}


@pytest.fixture(scope="module")
def ref():
    """Per mode: the JAX model's initial state and its dp2 sharded step's
    two losses; the port's one-process gradients and parameters after two
    ``TrainStep`` steps on those weights; the entries each capacity layer
    dropped on the first batch."""
    ids = _ids()
    out = {}
    for mode in MODES:
        jm = _jax_model(mode, CF)
        state = _state(jm)
        step = JStep(jm, JAdamW(learning_rate=LR, parameters=jm.parameters()),
                     lambda mm, i, l: mm(i, labels=l),
                     plan=jtrain_plan("dp2", data_axes=("dp",)))
        jax_losses = [float(step(ids, ids).numpy()) for _ in range(2)]
        tm = W.port_moe(state, mode, CF)
        ids_t = torch.from_numpy(ids).long()
        drops = []
        hooks = [layer.mlp.register_forward_hook(
            lambda mod, args, _: drops.append(_dropped(mod, args[0])))
            for layer in tm.layers]
        tm(ids_t, labels=ids_t).backward()
        for h in hooks:
            h.remove()
        grads = {n: p.grad.detach().numpy().copy()
                 for n, p in tm.named_parameters()}
        tm = W.port_moe(state, mode, CF)
        import paddlepaddle_tpu_torch as pt

        one = pt.TrainStep(tm, pt.AdamW(learning_rate=LR,
                                        parameters=tm.parameters()),
                           _loss, device="cpu")
        one_losses = [float(one(ids_t, ids_t)) for _ in range(2)]
        out[mode] = {"state": state, "jax": jax_losses, "grads": grads,
                     "one_losses": one_losses, "drops": drops,
                     "params": {n: p.detach().numpy().copy()
                                for n, p in tm.named_parameters()}}
    return ids, out


def _dropped(mod, x):
    """Entries the layer's capacity drops on ``x`` (the global batch)."""
    xf = x.reshape(-1, mod.d_model)
    logits = xf.float() @ mod.gate.weight.float()
    soe = tmoe._capacity_slot_maps(logits, mod.gate.topk, mod.num_experts,
                                   mod.capacity(xf.shape[0]),
                                   xf.shape[0])[2]
    return int((soe < 0).sum())


@pytest.fixture(scope="module")
def runs(ref):
    """Both forms of the port's dp2 step, every mode."""
    ids, r = ref
    states = {m: r[m]["state"] for m in MODES}
    spmd = spawn(W.moe_dp_session, args=(states, ids.astype(np.int64),
                                         CF, LR),
                 nprocs=2, timeout=300, pg_timeout=120)[0]
    single = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for mode in MODES:
            model = W.port_moe(states[mode], mode, CF)
            opt = W.TapAdamW(learning_rate=LR, parameters=model.parameters())
            step = ShardedTrainStep(model, opt, _loss,
                                    plan=train_plan("dp2", data_axes=("dp",)))
            try:
                single[mode] = W.moe_train(step, opt, ids.astype(np.int64),
                                           2)
            finally:
                step.close()
    finally:
        torch.set_num_threads(threads)
    return {"spmd": spmd, "single": single}


def test_capacity_binds_in_the_capacity_modes(ref):
    _, r = ref
    for mode in ("einsum", "sorted", "fused"):
        assert min(r[mode]["drops"]) > 0, (mode, r[mode]["drops"])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
def test_dp2_losses_match_the_reference_sharded_step(ref, runs, form, mode):
    _, r = ref
    got = runs[form][mode]["losses"]
    np.testing.assert_allclose(got, r[mode]["jax"], rtol=1e-5, atol=1e-6)
    # the one-process step agrees as well: the gap C20 opened is closed
    np.testing.assert_allclose(got, r[mode]["one_losses"], rtol=1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
def test_dp2_grads_and_params_match_one_process(ref, runs, form, mode):
    _, r = ref
    run = runs[form][mode]
    assert set(run["grads"]) == set(r[mode]["grads"])
    for name, g in run["grads"].items():
        np.testing.assert_allclose(g, r[mode]["grads"][name], atol=1e-5,
                                   err_msg=name)
    for name, p in run["params"].items():
        np.testing.assert_allclose(p, r[mode]["params"][name], atol=1e-4,
                                   err_msg=name)


def test_a_custom_gate_routes_the_global_batch_under_dp2(ref):
    ids, r = ref
    state = r["sorted"]["state"]
    ids_t = torch.from_numpy(ids).long()
    import paddlepaddle_tpu_torch as pt

    one = W.with_scaled_gates(W.port_moe(state, "sorted", CF))
    one(ids_t, labels=ids_t).backward()
    grads = {n: p.grad.detach().numpy().copy()
             for n, p in one.named_parameters()}
    one = W.with_scaled_gates(W.port_moe(state, "sorted", CF))
    s1 = pt.TrainStep(one, pt.AdamW(learning_rate=LR,
                                    parameters=one.parameters()),
                      _loss, device="cpu")
    want = [float(s1(ids_t, ids_t)) for _ in range(2)]
    model = W.with_scaled_gates(W.port_moe(state, "sorted", CF))
    opt = W.TapAdamW(learning_rate=LR, parameters=model.parameters())
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    step = ShardedTrainStep(model, opt, _loss,
                            plan=train_plan("dp2", data_axes=("dp",)))
    try:
        got = W.moe_train(step, opt, ids.astype(np.int64), 2)
    finally:
        step.close()
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, grads[name], atol=1e-5, err_msg=name)
    for name, p in one.named_parameters():
        np.testing.assert_allclose(got["params"][name], p.detach().numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def ep_runs():
    """The reference test's EP step (dp2 x ep4, AdamW 1e-2, five steps) in
    both packages, every mode; the port's in one process."""
    ids = _ids()
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mode in MODES:
            jm = _jax_model(mode, MoEConfig.tiny().capacity_factor)
            state = _state(jm)
            js = JStep(jm, JAdamW(learning_rate=1e-2,
                                  parameters=jm.parameters()),
                       lambda mm, i, l: mm(i, labels=l),
                       mesh=JMesh(shape=[2, 4], dim_names=["dp", "ep"]),
                       rules=jrules(), data_axes=("dp",))
            jax_losses = [float(js(ids, ids).numpy()) for _ in range(5)]
            import paddlepaddle_tpu_torch as pt

            m = W.port_moe(state, mode, MoEConfig.tiny().capacity_factor)
            step = ShardedTrainStep(
                m, pt.AdamW(learning_rate=1e-2, parameters=m.parameters()),
                lambda mm, i, l: mm(i, labels=l),
                mesh=ProcessMesh(shape=[2, 4], dim_names=["dp", "ep"]),
                rules=moe_sharding_rules(), data_axes=("dp",))
            try:
                ids_t = torch.from_numpy(ids).long()
                losses = [float(step(ids_t, ids_t)) for _ in range(5)]
                shapes = {n: tuple(p.shape) for n, p in step.params.items()}
                axes = step.plan.axes
            finally:
                step.close()
            out[mode] = (jax_losses, losses, shapes, axes)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_moe_expert_parallel_sharded(ep_runs, mode):
    """``tests/test_moe.py:60-85`` in the port: ``ShardedTrainStep(...,
    mesh=ProcessMesh([2, 4], ["dp", "ep"]), rules=moe_sharding_rules(),
    data_axes=("dp",))`` in one process; the losses fall and equal the JAX
    step's; each rank holds E/4 experts."""
    jax_losses, losses, shapes, axes = ep_runs[mode]
    assert axes == {"dp": 2, "ep": 4}
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=1e-6)
    E = MoEConfig.tiny().num_experts
    for layer in range(2):
        pre = f"layers.{layer}.mlp."
        assert shapes[pre + "w_gate_proj"] == (E // 4, 32, 64)
        assert shapes[pre + "w_up_proj"] == (E // 4, 32, 64)
        assert shapes[pre + "w_down_proj"] == (E // 4, 64, 32)
        assert shapes[pre + "gate.weight"] == (32, E)
