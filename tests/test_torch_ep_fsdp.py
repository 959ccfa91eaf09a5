"""Expert parallelism beside a parameter-sharding axis in the port's
``ShardedTrainStep`` on the CPU against the JAX package
(``paddlepaddle_tpu/parallel/sharded.py`` :87-216, ``parallel/moe.py``).

The reference's step over ``fsdp x ep`` is one global jitted function: the
trunk's matrices are sharded over ``fsdp`` (``moe_sharding_rules``), the
expert banks over ``ep``, the batch over the data axes. The port's ranks
gather the trunk where it is used (its gradient reduce-scattered over
``fsdp``), keep ``E/ep`` experts each, route the global batch over the
data group and sum the banks' gradients over the data group only
(``parallel/moe.py``'s module docstring names each collective's group).

The tiny MoE (``MoEConfig.tiny()``, sorted dispatch) from the JAX model's
initial weights, two steps on one ``[4, 16]`` batch, in the single-process
form (this process is rank 0 and the step starts the other three ranks):

* ``fsdp2 ep2`` with data axes ``("fsdp",)`` and ``dp1 fsdp2 ep2`` under
  the default ``("dp", "fsdp")``, AdamW at lr 1e-3: losses against the
  JAX ``ShardedTrainStep`` over the same mesh, rules and data axes at
  rtol 1e-5, every parameter after the steps at 1e-4 absolute;
* ``fsdp2 ep2`` with momentum SGD (lr 0.05), where a gradient summed over
  the wrong group (``ep`` on the banks or the trunk) would move the
  parameters twice as far: the same checks;
* the local shards: banks ``[E/2, ...]``, the trunk's matrices halved on
  their fsdp dim.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
from paddlepaddle_tpu.models.moe import MoEConfig, MoEForCausalLM
from paddlepaddle_tpu.optimizer import AdamW as JAdamW
from paddlepaddle_tpu.optimizer import Momentum as JMomentum
from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep
from paddlepaddle_tpu.parallel.moe import moe_sharding_rules as jrules

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import ProcessMesh
from paddlepaddle_tpu_torch.parallel import ShardedTrainStep
from paddlepaddle_tpu_torch.parallel.moe import moe_sharding_rules

STEPS = 2
# name: (mesh shape, axis names, data axes, optimizer)
CASES = {
    "fsdp2ep2": ([2, 2], ["fsdp", "ep"], ("fsdp",), "adamw"),
    "dp1fsdp2ep2": ([1, 2, 2], ["dp", "fsdp", "ep"], ("dp", "fsdp"),
                    "adamw"),
    "fsdp2ep2 momentum": ([2, 2], ["fsdp", "ep"], ("fsdp",), "momentum"),
}


def _loss(mm, i, l):  # noqa: E741
    return mm(i, labels=l)


def _opt(pkg, kind, params):
    if kind == "momentum":
        return pkg.Momentum(learning_rate=0.05, momentum=0.9,
                            parameters=params)
    return pkg.AdamW(learning_rate=1e-3, parameters=params)


@pytest.fixture(scope="module")
def runs():
    ids = np.random.default_rng(0).integers(0, 128, (4, 16)).astype(
        np.int32)
    cf = MoEConfig.tiny().capacity_factor
    out = {}
    threads = torch.get_num_threads()
    try:
        for name, (shape, names, data_axes, kind) in CASES.items():
            paddle.seed(7)
            jm = MoEForCausalLM(dataclasses.replace(MoEConfig.tiny(),
                                                    dispatch_mode="sorted"))
            state = {k: np.asarray(v).copy()
                     for k, v in jm.functional_state().items()}
            jopt = (JMomentum(learning_rate=0.05, momentum=0.9,
                              parameters=jm.parameters())
                    if kind == "momentum" else
                    JAdamW(learning_rate=1e-3, parameters=jm.parameters()))
            js = JStep(jm, jopt, _loss,
                       mesh=JMesh(shape=shape, dim_names=names),
                       rules=jrules(), data_axes=data_axes)
            jl = [float(js(ids, ids).numpy()) for _ in range(STEPS)]
            jp = {n: np.asarray(v) for n, v in js.params.items()}
            model = W.port_moe(state, "sorted", cf)
            torch.set_num_threads(1)
            step = ShardedTrainStep(
                model, _opt(pt, kind, model.parameters()), _loss,
                mesh=ProcessMesh(shape=shape, dim_names=names),
                rules=moe_sharding_rules(), data_axes=data_axes)
            try:
                ids_t = torch.from_numpy(ids).long()
                tl = [float(step(ids_t, ids_t)) for _ in range(STEPS)]
                full = {n: t.numpy() for n, t in step.full_params().items()}
                shapes = {n: tuple(p.shape) for n, p in step.params.items()}
            finally:
                step.close()
                torch.set_num_threads(threads)
            out[name] = (jl, jp, tl, full, shapes)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_the_reference_sharded_step(runs, name):
    jl, _, tl, _, _ = runs[name]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_match_the_reference_sharded_step(runs, name):
    _, jp, _, full, _ = runs[name]
    assert set(full) == set(jp)
    for n, p in full.items():
        np.testing.assert_allclose(p, jp[n], atol=1e-4, err_msg=n)


def test_local_shards_are_the_plan_blocks(runs):
    E = MoEConfig.tiny().num_experts
    for name in CASES:
        shapes = runs[name][4]
        pre = "layers.0."
        assert shapes[pre + "mlp.w_gate_proj"] == (E // 2, 32, 64), name
        assert shapes[pre + "mlp.w_down_proj"] == (E // 2, 64, 32), name
        assert shapes[pre + "mlp.gate.weight"] == (32, E), name
        assert shapes[pre + "self_attn.q_proj.weight"] == (16, 32), name
        assert shapes[pre + "self_attn.o_proj.weight"] == (32, 16), name
