"""Megatron sequence parallelism in the port on the CPU against the JAX
package (``paddlepaddle_tpu/parallel/mpu.py`` :166-198,
``distributed/auto_parallel/__init__.py`` :83-96).

The reference constrains activations to sequence blocks over ``mp`` and
GSPMD computes the dense values, so its one process, with no mesh, is the
oracle. The port's two ranks of ``mp2`` each hold one block of the
sequence between the sequence-parallel layers; a parameter used on the
blocks (a norm's weight) has a partial gradient on each rank, and
``ShardedTrainStep`` sums it over ``mp`` (``mark_as_sequence_parallel_
parameter``): a missing sum is the fault these cases look for, so they
compare the norm weights' gradients and not only the loss.

Both cases run the port's ``ShardedTrainStep`` over ``mp2`` in the
single-process form (this process is rank 0, the step starts rank 1),
momentum SGD (lr 0.1; a gradient's scale shows in the update), two steps:

* the five ``mpu`` names in one block (``scatter_to_sequence_parallel``,
  a marked norm, ``ColumnSequenceParallelLinear``, silu,
  ``RowSequenceParallelLinear`` whose bias is a sequence-parallel
  parameter, the residual, ``gather_from_sequence_parallel``) against the
  JAX layers: losses (rtol 1e-5), the first step's gradients of the norm
  weight, the row bias and rank 0's column block (1e-5), every parameter
  after the steps (1e-5);
* ``parallelize`` with ``SequenceParallelBegin`` on the embedding, the
  projections ``ColWiseParallel`` / ``RowWiseParallel`` and
  ``SequenceParallelEnd`` on the LM head of the tiny Llama, against the
  JAX ``parallelize`` of the same plan: losses, the first gradients of
  every norm weight (summed over ``mp``) and of the embedding, every
  parameter after the steps (1e-5); the marks ``parallelize`` leaves;
* C23: the tensor-parallel plan alone through ``parallelize`` on ``mp2``
  (rules that replicate everything, the roles from the placements).
"""

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
import paddlepaddle_tpu.distributed as JD
from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu.nn.norm import RMSNorm as JRMSNorm
from paddlepaddle_tpu.optimizer import Momentum as JMomentum
from paddlepaddle_tpu.parallel import mpu as jmpu

import torch_dist_workers as W
import paddlepaddle_tpu_torch.distributed as D
from paddlepaddle_tpu_torch.distributed import ShardingPlan
from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

STEPS, LR = 2, 0.1
H, F = 16, 32


def _jax_train(model, loss_of, steps):
    """The JAX eager loop: losses, the first gradients by name, the
    parameters after ``steps`` momentum steps."""
    opt = JMomentum(learning_rate=LR, momentum=0.9,
                    parameters=model.parameters())
    losses, first = [], None
    for _ in range(steps):
        loss = loss_of(model)
        loss.backward()
        if first is None:
            first = {n: np.asarray(p.grad.numpy()).copy()
                     for n, p in model.named_parameters()}
        losses.append(float(loss.numpy()))
        opt.step()
        opt.clear_grad()
    return losses, first, {n: np.asarray(p.numpy()).copy()
                           for n, p in model.named_parameters()}


def _port_train(model, loss_fn, batch, steps):
    opt = W.TapMomentum(learning_rate=LR, momentum=0.9,
                        parameters=model.parameters())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    step = ShardedTrainStep(model, opt, loss_fn,
                            plan=ShardingPlan("mp2", rules=[(r".*", ())],
                                              data_axes=()))
    try:
        losses = [float(step(*batch)) for _ in range(steps)]
        full = {n: t.numpy() for n, t in step.full_params().items()}
        shapes = {n: tuple(p.shape) for n, p in step.params.items()}
    finally:
        step.close()
        torch.set_num_threads(threads)
    return losses, opt.first, full, shapes


class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.norm = JRMSNorm(H)
        jmpu.mark_as_sequence_parallel_parameter(self.norm.weight)
        self.col = jmpu.ColumnSequenceParallelLinear(H, F, has_bias=True,
                                                     gather_output=False)
        self.row = jmpu.RowSequenceParallelLinear(F, H, has_bias=True,
                                                  input_is_parallel=True)

    def forward(self, x):
        x = jmpu.scatter_to_sequence_parallel(x)
        y = self.row(paddle.nn.functional.silu(self.col(self.norm(x))))
        return jmpu.gather_from_sequence_parallel(x + y)


@pytest.fixture(scope="module")
def mpu_runs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, H)).astype(np.float32)
    t = rng.standard_normal((2, 8, H)).astype(np.float32)
    paddle.seed(5)
    jnet = _JNet()
    with paddle.no_grad():
        # a norm weight away from ones, so its gradient's scale shows
        jnet.norm.weight.set_value(
            1.0 + 0.1 * rng.standard_normal(H).astype(np.float32))
    state = {n: np.asarray(p.numpy()).copy()
             for n, p in jnet.named_parameters()}
    want = _jax_train(jnet, lambda m: ((m(paddle.to_tensor(x))
                                        - paddle.to_tensor(t)) ** 2).mean(),
                      STEPS)
    net = W.sp_mlp_net(state, H, F)
    got = _port_train(net, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                      (torch.from_numpy(x), torch.from_numpy(t)), STEPS)
    return state, want, got


def test_mpu_sequence_parallel_losses_match_the_reference(mpu_runs):
    _, (jl, _, _), (tl, _, _, _) = mpu_runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_mpu_sequence_parallel_gradients_include_the_norm(mpu_runs):
    """The norm weight and the row bias are summed over ``mp``; the
    column weight's gradient is rank 0's block of the whole one."""
    _, (_, jg, _), (_, tg, _, shapes) = mpu_runs
    for name in ("norm.weight", "row.bias", "row.weight", "col.bias"):
        w = jg[name]
        want = (w[:w.shape[0] // 2] if name in ("row.weight", "col.bias")
                else w)
        np.testing.assert_allclose(tg[name], want, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tg["col.weight"], jg["col.weight"][:, :F // 2],
                               atol=1e-5)
    assert shapes["col.weight"] == (H, F // 2)
    assert shapes["row.weight"] == (F // 2, H)
    assert shapes["norm.weight"] == (H,)


def test_mpu_sequence_parallel_parameters_match_after_the_steps(mpu_runs):
    _, (_, _, jp), (_, _, full, _) = mpu_runs
    assert set(full) == set(jp)
    for n, p in full.items():
        np.testing.assert_allclose(p, jp[n], atol=1e-5, err_msg=n)


def test_mpu_sequence_parallel_layers_in_one_process_are_dense():
    """With no group the five names compute the dense block: the port's
    one-process net against the JAX net's output."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, H)).astype(np.float32)
    paddle.seed(6)
    jnet = _JNet()
    state = {n: np.asarray(p.numpy()).copy()
             for n, p in jnet.named_parameters()}
    want = np.asarray(jnet(paddle.to_tensor(x)).numpy())
    got = W.sp_mlp_net(state, H, F)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert getattr(W.sp_mlp_net(state, H, F).row.bias, "sequence_parallel")


def _sp_plan(pkg):
    return {"mp_config": {"parallelize_plan": {
        "embed_tokens": pkg.auto_parallel.SequenceParallelBegin(),
        r"model\.layers\.\d+\.self_attn\.(q|k|v)_proj": pkg.ColWiseParallel(),
        r"model\.layers\.\d+\.self_attn\.o_proj": pkg.RowWiseParallel(),
        r"model\.layers\.\d+\.mlp\.(gate|up)_proj": pkg.ColWiseParallel(),
        r"model\.layers\.\d+\.mlp\.down_proj": pkg.RowWiseParallel(),
        "lm_head": [pkg.ColWiseParallel(gather_output=True),
                    pkg.auto_parallel.SequenceParallelEnd()]}}}


@pytest.fixture(scope="module")
def begin_end_runs():
    ids = np.random.default_rng(7).integers(0, 64, (2, 16)).astype(np.int32)
    paddle.seed(13)
    jm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           max_len=64))
    state = {k: np.asarray(v).astype(np.float32)
             for k, v in jm.functional_state().items()
             if k not in ("model.rope_cos", "model.rope_sin")}
    JD.parallelize(jm, config=_sp_plan(JD))
    want = _jax_train(jm, lambda m: m(ids, labels=ids), STEPS)
    tm = W.port_llama(state, "float32", W.FSDP_CFG)
    D.parallelize(tm, config=_sp_plan(D))
    marks = {n for n, p in tm.named_parameters()
             if getattr(p, "sequence_parallel", False)}
    seq = {n for n, m in tm.named_modules() if getattr(m, "_sp_seq", False)}
    ids_t = torch.from_numpy(ids).long()
    got = _port_train(tm, lambda m, i: m(i, labels=i), (ids_t,), STEPS)
    return want, got, marks, seq


def test_sequence_parallel_begin_end_losses_match_the_reference(
        begin_end_runs):
    (jl, _, _), (tl, _, _, _), _, _ = begin_end_runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_sequence_parallel_begin_end_norm_gradients(begin_end_runs):
    """Every norm weight between Begin and End is a sequence-parallel
    parameter, its first gradient summed over ``mp`` to the one-device
    value; the embedding (whose output the Begin scatter splits) gets its
    whole gradient on each rank."""
    (_, jg, _), (_, tg, _, _), marks, seq = begin_end_runs
    norms = sorted(n for n in jg if n.endswith("norm.weight"))
    assert marks == set(norms) and len(norms) == 5
    for n in norms + ["model.embed_tokens.weight"]:
        np.testing.assert_allclose(tg[n], jg[n], atol=1e-5, err_msg=n)
    assert seq == {f"model.layers.{i}.{m}" for i in range(2) for m in (
        "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
        "mlp.down_proj")}


def test_sequence_parallel_begin_end_parameters_match(begin_end_runs):
    (_, _, jp), (_, _, full, shapes), _, _ = begin_end_runs
    assert set(full) == set(jp)
    for n, p in full.items():
        np.testing.assert_allclose(p, jp[n], atol=1e-5, err_msg=n)
    assert shapes["model.layers.0.self_attn.q_proj.weight"] == (32, 16)
    assert shapes["model.layers.0.mlp.down_proj.weight"] == (48, 32)
    assert shapes["lm_head.weight"] == (32, 32)


def _tp_plan(pkg):
    return {"mp_config": {"parallelize_plan": {
        r"model\.layers\.\d+\.self_attn\.(q|k|v)_proj": pkg.ColWiseParallel(),
        r"model\.layers\.\d+\.self_attn\.o_proj": pkg.RowWiseParallel(),
        r"model\.layers\.\d+\.mlp\.(gate|up)_proj": pkg.ColWiseParallel(),
        r"model\.layers\.\d+\.mlp\.down_proj": pkg.RowWiseParallel(),
        "lm_head": pkg.ColWiseParallel(gather_output=True)}}}


def test_c23_parallelize_placements_wire_their_collectives():
    """C23: a plan's view cut a weight by its ``dist_spec`` (what
    ``parallelize``'s ``ColWiseParallel`` / ``RowWiseParallel`` set) but
    took its Megatron role from the rule table alone, so under rules that
    replicate it the shard ran with no collective (the vocab-sharded head's
    labels fell outside its block: the parent raised an index error where
    the reference's loss is 4.5401). The role now follows the placement:
    the tensor-parallel plan alone on ``mp2`` gives the JAX package's
    losses and parameters."""
    ids = np.random.default_rng(7).integers(0, 64, (2, 16)).astype(np.int32)
    paddle.seed(13)
    jm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           max_len=64))
    state = {k: np.asarray(v).astype(np.float32)
             for k, v in jm.functional_state().items()
             if k not in ("model.rope_cos", "model.rope_sin")}
    JD.parallelize(jm, config=_tp_plan(JD))
    jl, _, jp = _jax_train(jm, lambda m: m(ids, labels=ids), STEPS)
    tm = W.port_llama(state, "float32", W.FSDP_CFG)
    D.parallelize(tm, config=_tp_plan(D))
    ids_t = torch.from_numpy(ids).long()
    tl, _, full, _ = _port_train(tm, lambda m, i: m(i, labels=i), (ids_t,),
                                 STEPS)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n, p in full.items():
        np.testing.assert_allclose(p, jp[n], atol=1e-5, err_msg=n)
