"""The single-process form of the port's ``ShardedTrainStep`` on the CPU
against the JAX package (``paddlepaddle_tpu/parallel/sharded.py`` :87,
``tests/test_shard_plan.py`` :264-317).

In a process with no process group the reference builds
``ShardedTrainStep(..., plan=train_plan("dp2mp2", data_axes=("dp",)))`` in
one call and drives every device. So does the port: this test process is
rank 0, and the step starts the other ranks as worker processes, each on
its own view of the model, its optimizer rebuilt from rank 0's class and
settings, and the loss function shipped to it by value.

* The reference's two texts, their lambdas included: ``dp2`` against the
  JAX one-device step at rtol 1e-5 (the data-parallel sums are the only
  reordering) and ``dp2mp2`` against it at 1e-4 (the row-parallel matmuls
  reorder the hidden sums too), both also against the JAX sharded step
  over the same plan; the parameters after ``sync_to_model()`` against
  the port's one-process ``TrainStep`` at 1e-5.
* An ``apply_decay_param_fun`` lambda and a learning-rate scheduler
  stepped on rank 0 hold on every rank: two steps with both match the
  one-process step with both (losses rtol 1e-5; parameters 1e-4, a tenth
  of one step's move at lr 1e-3, as Adam amplifies the noise of near-zero
  gradients; the norms' skipped decay alone moves them 5e-4).
* Lifetime: ``close()`` and garbage collection leave no child process; a
  worker killed between steps makes the next step raise on rank 0 within
  10 s, naming the rank; a loss function that cannot be sent to a worker
  raises at construction, before any worker starts; a refusal that every
  rank raises (a loss with no token count) leaves the workers following;
  a bf16 batch tensor reaches every rank.
"""

import gc
import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.shard_plan import train_plan as jtrain_plan
from paddlepaddle_tpu.jit.train import TrainStep as JTrainStep
from paddlepaddle_tpu.models import LlamaConfig, LlamaForCausalLM
from paddlepaddle_tpu.optimizer import AdamW as JAdamW
from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import train_plan
from paddlepaddle_tpu_torch.distributed.ship import ShipError
from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
# the reference texts: (ids seed, paddle seed, steps, rtol)
TEXTS = {"dp2": (0, 7, 2, 1e-5), "dp2mp2": (1, 9, 1, 1e-4)}


def _jcfg():
    return LlamaConfig.tiny(vocab_size=64, hidden_size=32, layers=2,
                            heads=4, kv_heads=2, max_len=64)


def _jax_state(m):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in m.functional_state().items()
            if k not in ("model.rope_cos", "model.rope_sin")}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Rank 0 and its workers share this host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(TEXTS))
def text(request):
    spec = request.param
    ids_seed, seed, n, _ = TEXTS[spec]
    ids = np.random.default_rng(ids_seed).integers(0, 64, (4, 16)).astype(
        np.int32)
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731, E741
    paddle.seed(seed)
    m1 = LlamaForCausalLM(_jcfg())
    state = _jax_state(m1)
    s1 = JTrainStep(m1, JAdamW(learning_rate=1e-3,
                               parameters=m1.parameters()), loss_fn)
    ref = [float(s1(ids, ids).numpy()) for _ in range(n)]
    paddle.seed(seed)
    m2 = LlamaForCausalLM(_jcfg())
    s2 = JStep(m2, JAdamW(learning_rate=1e-3, parameters=m2.parameters()),
               loss_fn, plan=jtrain_plan(spec, data_axes=("dp",)))
    jsharded = [float(s2(ids, ids).numpy()) for _ in range(n)]

    ids_t = torch.from_numpy(ids).long()
    port = W.port_llama(state, "float32", CFG)
    step = ShardedTrainStep(
        port, pt.AdamW(learning_rate=1e-3, parameters=port.parameters()),
        loss_fn, plan=train_plan(spec, data_axes=("dp",)))
    try:
        got = [float(step(ids_t, ids_t)) for _ in range(n)]
        step.sync_to_model()
        shapes = {k: tuple(p.shape) for k, p in step.params.items()}
    finally:
        step.close()
    one = W.port_llama(state, "float32", CFG)
    s3 = pt.TrainStep(one, pt.AdamW(learning_rate=1e-3,
                                    parameters=one.parameters()),
                      loss_fn, device="cpu")
    for _ in range(n):
        s3(ids_t, ids_t)
    diffs = {k: float((p.detach() - q.detach()).abs().max())
             for (k, p), q in zip(port.named_parameters(), one.parameters())}
    return spec, ref, jsharded, got, diffs, shapes, step


def test_losses_match_the_reference_texts(text):
    spec, ref, jsharded, got, _, _, _ = text
    rtol = TEXTS[spec][3]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * 0.1)
    np.testing.assert_allclose(got, jsharded, rtol=rtol, atol=rtol * 0.1)


def test_synced_parameters_match_one_process(text):
    _, _, _, _, diffs, _, _ = text
    assert "model.norm.weight" in diffs
    for name, d in diffs.items():
        assert d < 1e-5, (name, d)


def test_rank0_holds_its_shards_and_the_workers_exited(text):
    spec, _, _, _, _, shapes, step = text
    assert step.plan.bound and step.plan.rank == 0
    q = shapes["model.layers.0.self_attn.q_proj.weight"]
    assert q == ((32, 32) if spec == "dp2" else (32, 16))
    assert [p.exitcode for p in step.workers.procs] == \
        [0] * (step.plan.n_devices - 1)


def test_decay_lambda_and_rank0_scheduler_hold_on_every_rank():
    state = _jax_state(LlamaForCausalLM(_jcfg()))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (4, 16))).long()
    decay = lambda name: "norm" not in name  # noqa: E731

    def make(m):
        sched = pt.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                          gamma=0.1)
        # named: the decay function reads the parameters' names
        return sched, pt.AdamW(learning_rate=sched, weight_decay=0.5,
                               parameters=m.named_parameters(),
                               apply_decay_param_fun=decay)

    def run(step, sched):
        out = []
        for _ in range(2):
            out.append(float(step(ids, ids)))
            sched.step()
        return out

    m1 = W.port_llama(state, "float32", CFG)
    sched1, opt1 = make(m1)
    want = run(pt.TrainStep(m1, opt1, lambda m, i, l: m(i, labels=l),
                            device="cpu"), sched1)
    m2 = W.port_llama(state, "float32", CFG)
    sched2, opt2 = make(m2)
    step = ShardedTrainStep(m2, opt2, lambda m, i, l: m(i, labels=l),
                            plan=train_plan("dp2mp2", data_axes=("dp",)))
    try:
        got = run(step, sched2)
        step.sync_to_model()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for (name, p), q in zip(m2.named_parameters(), m1.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-4, err_msg=name)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _small_step(spec="dp2"):
    m = pt.LlamaForCausalLM(pt.LlamaConfig(**CFG), device="cpu")
    return ShardedTrainStep(m, pt.AdamW(parameters=m.parameters()),
                            lambda m, i, l: m(i, labels=l),
                            plan=train_plan(spec, data_axes=("dp",)))


def test_close_and_collection_leave_no_child_process():
    ids = torch.zeros((2, 8), dtype=torch.long)
    step = _small_step()
    step(ids, ids)
    pids = step.workers.pids
    step.close()
    step.close()                      # idempotent
    assert not any(_alive(p) for p in pids)
    with pytest.raises(RuntimeError, match="closed"):
        step(ids, ids)
    step = _small_step("dp2mp2")
    pids = step.workers.pids
    assert all(_alive(p) for p in pids)
    del step
    gc.collect()
    assert not any(_alive(p) for p in pids)
    assert not mp.active_children()


def test_a_dead_worker_fails_the_next_step_naming_it():
    ids = torch.zeros((2, 8), dtype=torch.long)
    step = _small_step("dp2mp2")
    try:
        step(ids, ids)
        victim = step.workers.procs[1]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 2 .* exited"):
            step(ids, ids)
        assert time.monotonic() - t0 < 10.0
    finally:
        step.close()
    assert not mp.active_children()


def test_a_loss_that_cannot_be_shipped_raises_at_construction():
    lock = threading.Lock()

    def loss_fn(m, i, l):  # noqa: E741
        with lock:
            return m(i, labels=l)

    m = pt.LlamaForCausalLM(pt.LlamaConfig(**CFG), device="cpu")
    before = set(p.pid for p in mp.active_children())
    with pytest.raises(ShipError, match="closure 'lock'"):
        ShardedTrainStep(m, pt.AdamW(parameters=m.parameters()), loss_fn,
                         plan=train_plan("dp2", data_axes=("dp",)))
    assert set(p.pid for p in mp.active_children()) == before


def test_a_refusal_on_every_rank_leaves_the_workers_following():
    """A loss that reports no valid-token count is refused on rank 0 and
    on each worker at the same point; the workers log it and follow on,
    so the step still syncs and closes cleanly."""
    ids = torch.zeros((2, 8), dtype=torch.long)
    m = pt.LlamaForCausalLM(pt.LlamaConfig(**CFG), device="cpu")
    step = ShardedTrainStep(m, pt.AdamW(parameters=m.parameters()),
                            lambda m, i, l: m(i).float().square().mean(),
                            plan=train_plan("dp2", data_axes=("dp",)))
    try:
        with pytest.raises(NotImplementedError, match="valid-token count"):
            step(ids, ids)
        assert all(p.is_alive() for p in step.workers.procs)
        step.sync_to_model()
    finally:
        step.close()
    assert [p.exitcode for p in step.workers.procs] == [0]


def test_a_bf16_batch_tensor_reaches_every_rank():
    """Batch tensors go to the workers as CPU tensors in their own dtype
    (numpy has no bf16): a bf16 scale in the batch gives the loss of the
    same step without it."""
    state = _jax_state(LlamaForCausalLM(_jcfg()))
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (4, 16))).long()
    scale = torch.ones((4, 1), dtype=torch.bfloat16)
    got = []
    for with_scale in (False, True):
        m = W.port_llama(state, "float32", CFG)
        fn = ((lambda m, i, l, s: m(i, labels=l) * s.float().mean())
              if with_scale else (lambda m, i, l: m(i, labels=l)))
        step = ShardedTrainStep(m, pt.AdamW(parameters=m.parameters()), fn,
                                plan=train_plan("dp2", data_axes=("dp",)))
        try:
            batch = (ids, ids, scale) if with_scale else (ids, ids)
            got.append([float(step(*batch)) for _ in range(2)])
        finally:
            step.close()
    assert got[1] == got[0]
