"""Context parallelism in the port on the CPU against the JAX package:
ring attention (``paddlepaddle_tpu/ops/kernels/ring_attention.py``),
``LlamaConfig.context_parallel_axis`` (reference ``models/llama.py:251``)
and ``ShardedTrainStep(seq_axis=...)`` (reference ``parallel/sharded.py``
:97-98, :171-175; ``tests/test_context_parallel.py``,
``tests/test_ring_attention.py``).

* ``ring_attention`` in one process (the reference's single-controller
  call: the port computes attention over the whole sequences in one call)
  against the JAX ``ring_attention`` under ``shard_map`` on ``dp2 sp4``
  (forward) and ``dp1 sp4`` (q, k and v gradients), causal and full, at
  1e-5 — the plain route and the kernel route's function (the flash
  kernels' autograd function, whose wrappers on CPU tensors run the plain
  versions);
* four gloo ranks (one ``spawn``, rank body ``tests/torch_dist_workers.py:
  context_parallel_session``): ring attention over ``sp4`` with K/V moving
  point to point, both routes, GQA (2 KV heads for 4 query heads) and
  MHA, causal and full: each rank's output block and its q, k, v gradient
  blocks against the dense attention at 1e-5; the ring's sends counted
  (``collective_stats``);
* the reference's ``test_cp_loss_matches_dense_llama``: one process, mesh
  ``[1, 4]``, the context-parallel loss equal to the dense loss and to the
  JAX model's;
* ``dp2 sp2`` context-parallel training (labels masked across a block
  boundary, so the blocks count different valid tokens and block 0's last
  position has no target), in both forms of the port's step, against the
  JAX ``ShardedTrainStep`` with ``seq_axis="sp"``: losses at rtol 1e-5,
  parameters at 1e-4;
* a model with no context-parallel path under ``seq_axis`` (every rank
  gets the whole sequence): losses against the JAX step's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddlepaddle_tpu as paddle
from paddlepaddle_tpu.distributed.mesh import ProcessMesh as JMesh
from paddlepaddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddlepaddle_tpu.models import LlamaConfig as JConfig
from paddlepaddle_tpu.models import LlamaForCausalLM as JLlama
from paddlepaddle_tpu.models.llama import llama_sharding_rules as jrules
from paddlepaddle_tpu.ops.kernels import ring_attention as JR
from paddlepaddle_tpu.optimizer import AdamW as JAdamW
from paddlepaddle_tpu.parallel import ShardedTrainStep as JStep

import torch_dist_workers as W
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.distributed import ProcessMesh, set_mesh, spawn
from paddlepaddle_tpu_torch.ops.kernels import ring_attention as TR
from paddlepaddle_tpu_torch.ops.kernels.flash_attention import \
    flash_attention_plain

STEPS = 2
ROUTES = ("plain", "flash")


def _qkv(seed, b, s, h, d, kvh=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh or h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh or h, d)).astype(np.float32)
    return q, k, v


def _port_ring(route, q, k, v, mesh, causal):
    """The port's one-process ring by ``route``."""
    if route == "plain":
        return TR.ring_attention(q, k, v, mesh, causal=causal)
    assert TR.ring_of(mesh, "sp").local
    return TR._whole(q, k, v, causal, 1.0 / float(np.sqrt(q.shape[-1])),
                     kernels=True)


def _dense(q, k, v, causal):
    rep = q.shape[2] // k.shape[2]
    return flash_attention_plain(q, k.repeat_interleave(rep, 2),
                                 v.repeat_interleave(rep, 2), causal,
                                 1.0 / float(np.sqrt(q.shape[-1])))[0]


@functools.lru_cache(maxsize=None)
def _jax_ring(causal):
    q, k, v = _qkv(0, 2, 32, 4, 8)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))
    return np.asarray(JR.ring_attention(q, k, v, jmesh, sp_axis="sp",
                                        causal=causal, data_axis="dp"))


@functools.lru_cache(maxsize=None)
def _jax_ring_grads():
    q, k, v = _qkv(1, 1, 16, 2, 4)
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("dp", "sp"))
    return jax.jit(jax.grad(lambda a, b, c: jnp.sum(JR.ring_attention(
        a, b, c, jmesh, causal=True, data_axis="dp") ** 2),
        argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_the_reference(causal, route):
    """``tests/test_ring_attention.py:30``'s case: ``dp2 sp4``, data axis
    ``dp``."""
    q, k, v = _qkv(0, 2, 32, 4, 8)
    want = _jax_ring(causal)
    mesh = ProcessMesh(shape=[2, 4], dim_names=["dp", "sp"])
    got = _port_ring(route, *(torch.from_numpy(a) for a in (q, k, v)), mesh,
                     causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_ring_attention_grads_match_the_reference(route):
    """``tests/test_ring_attention.py:51``'s case: ``dp1 sp4``, causal,
    the gradient of ``sum(out ** 2)``; k and v as well as q."""
    q, k, v = _qkv(1, 1, 16, 2, 4)
    jg = _jax_ring_grads()
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    mesh = ProcessMesh(shape=[1, 4], dim_names=["dp", "sp"])
    (_port_ring(route, *ts, mesh, True) ** 2).sum().backward()
    for t, want, name in zip(ts, jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_ring_flash_attention_needs_a_mesh_and_a_divisible_sequence():
    q = torch.zeros(1, 6, 2, 4)
    for pkg in (TR, JR):
        with pytest.raises(ValueError, match="needs a mesh"):
            pkg.ring_flash_attention(q, q, q) if pkg is TR else \
                pkg.ring_flash_attention(paddle.to_tensor(q.numpy()),
                                         paddle.to_tensor(q.numpy()),
                                         paddle.to_tensor(q.numpy()))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        TR.ring_attention(q, q, q, ProcessMesh(shape=[4],
                                               dim_names=["sp"]))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        JR.ring_attention(q.numpy(), q.numpy(), q.numpy(),
                          Mesh(np.array(jax.devices()[:4]), ("sp",)))


def _llama_state(seed, **kw):
    paddle.seed(seed)
    m = JLlama(JConfig.tiny(**kw))
    return m, {k: np.asarray(v).astype(np.float32)
               for k, v in m.functional_state().items()
               if k not in ("model.rope_cos", "model.rope_sin")}


def test_cp_loss_matches_dense_llama():
    """``tests/test_context_parallel.py:37`` through the port: the same
    weights, the context-parallel forward equal to the dense one (and to
    the JAX model's context-parallel loss), the axis set after
    construction as the reference test sets it."""
    jm, state = _llama_state(11, vocab_size=32, hidden_size=32, layers=1,
                             heads=4, kv_heads=4, max_len=32)
    ids = np.random.default_rng(0).integers(0, 32, (2, 16)).astype(np.int32)
    jmesh = JMesh(shape=[1, 4], dim_names=["dp", "sp"])
    jset_mesh(jmesh)
    try:
        jm.config.context_parallel_axis = "sp"
        want = float(jm(ids, labels=ids).numpy())
    finally:
        jset_mesh(None)
        jm.config.context_parallel_axis = None
    cfg = pt.LlamaConfig(vocab_size=32, hidden_size=32, intermediate_size=96,
                         num_hidden_layers=1, num_attention_heads=4,
                         num_key_value_heads=4, max_position_embeddings=32)
    m = W.cp_llama(state, cfg.__dict__)
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        dense = float(m(ids_t, labels=ids_t))
        set_mesh(ProcessMesh(shape=[1, 4], dim_names=["dp", "sp"]))
        try:
            m.config.context_parallel_axis = "sp"
            cp = float(m(ids_t, labels=ids_t))
        finally:
            set_mesh(None)
            m.config.context_parallel_axis = None
    assert abs(dense - cp) < 1e-5, (dense, cp)
    np.testing.assert_allclose(cp, want, rtol=1e-5)


def _batch():
    ids = np.random.default_rng(2).integers(0, 64, (4, 32)).astype(np.int32)
    labels = ids.copy()
    labels[1, :11] = -100
    labels[2, 16] = -100      # block 1's first label: block 0's last target
    return ids, labels


def _jax_cp_step(cp):
    jm, state = _llama_state(11, vocab_size=64, hidden_size=32, layers=2,
                             heads=4, kv_heads=2, max_len=64)
    ids, labels = _batch()
    jmesh = JMesh(shape=[2, 2], dim_names=["dp", "sp"])
    jset_mesh(jmesh)
    try:
        jm.config.context_parallel_axis = "sp" if cp else None
        js = JStep(jm, JAdamW(learning_rate=1e-3,
                              parameters=jm.parameters()),
                   lambda mm, i, l: mm(i, labels=l), mesh=jmesh,
                   rules=jrules(), data_axes=("dp",), seq_axis="sp")
        losses = [float(js(ids, labels).numpy()) for _ in range(STEPS)]
    finally:
        jset_mesh(None)
    return state, losses, {n: np.asarray(v) for n, v in js.params.items()}


@pytest.fixture(scope="module")
def cp_runs():
    """The JAX ``dp2 sp2`` step; the port's in both forms (the SPMD form
    in the four-rank job that also runs the ring cases)."""
    state, jl, jp = _jax_cp_step(True)
    ids, labels = _batch()
    ring_cases = []
    for kvh in (4, 2):
        q, k, v = _qkv(5 + kvh, 2, 32, 4, 8, kvh)
        cot = np.random.default_rng(9).standard_normal(q.shape).astype(
            np.float32)
        for causal in (True, False):
            for route in ROUTES:
                ring_cases.append((f"kvh{kvh} causal{causal} {route}", q, k,
                                   v, cot, causal, route))
    ranks = spawn(W.context_parallel_session,
                  args=(ring_cases, state, ids.astype(np.int64),
                        labels.astype(np.int64), STEPS),
                  nprocs=4, timeout=300, pg_timeout=120)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    step = W.cp_step(state, [2, 2], ["dp", "sp"])
    try:
        single = W.cp_train(step, ids.astype(np.int64),
                            labels.astype(np.int64), STEPS)
        single["workers"] = len(step.workers.procs)
    finally:
        step.close()
        torch.set_num_threads(threads)
    return {"ring_cases": ring_cases, "ranks": ranks, "jax": (jl, jp),
            "single": single}


def test_ring_attention_over_four_ranks_matches_dense(cp_runs):
    for key, q, k, v, cot, causal, route in cp_runs["ring_cases"]:
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
        out = _dense(*ts, causal)
        (out * torch.from_numpy(cot)).sum().backward()
        want = [out.detach().numpy()] + [t.grad.numpy() for t in ts]
        for r, got in enumerate(cp_runs["ranks"]):
            for name, g, w in zip(("out", "dq", "dk", "dv"), got[key], want):
                np.testing.assert_allclose(
                    g, np.split(w, 4, axis=1)[r], rtol=1e-5, atol=1e-5,
                    err_msg=f"{key} rank {r} {name}")


def test_the_ring_moves_kv_point_to_point(cp_runs):
    """Forward and backward, each rank sends its K/V (un-repeated) to the
    next rank three times, and in the kernel route's backward the dK/dV
    accumulators four times (f32)."""
    b, s_loc, d = 2, 8, 8
    for kvh in (4, 2):
        kv = 2 * b * s_loc * kvh * d * 4                   # k and v, f32
        for route in ROUTES:
            got = cp_runs["ranks"][1][f"kvh{kvh} causalTrue {route}"
                                      " p2p"]
            if route == "flash":
                want = (3 + 3) * kv + 4 * kv
                calls = 3 + 3 + 4
            else:
                want = 2 * 3 * kv                     # forward and backward
                calls = 2 * 2 * 3
            assert got == {"calls": calls, "seconds": 0.0,
                           "bytes": want}, (kvh, route, got)


@pytest.mark.parametrize("form", ["spmd", "single"])
def test_dp2sp2_training_matches_the_reference_sharded_step(cp_runs, form):
    jl, jp = cp_runs["jax"]
    run = (cp_runs["ranks"][0]["dp2sp2"] if form == "spmd"
           else cp_runs["single"])
    np.testing.assert_allclose(run["losses"], jl, rtol=1e-5)
    for r in cp_runs["ranks"][1:]:
        assert r["dp2sp2"]["losses"] == cp_runs["ranks"][0]["dp2sp2"][
            "losses"]
    assert set(run["params"]) == set(jp)
    for n, p in run["params"].items():
        np.testing.assert_allclose(p, jp[n], atol=1e-4, err_msg=n)
    if form == "single":
        assert run["workers"] == 3


def test_a_model_without_a_context_parallel_path_keeps_whole_sequences():
    """``seq_axis="sp"`` over a model whose attention has no ring (its
    ``context_parallel_axis`` is None): the reference's GSPMD computes it
    globally; the port gives every rank the whole sequence, so the losses
    are the JAX step's."""
    state, jl, _ = _jax_cp_step(False)
    ids, labels = _batch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    step = W.cp_step(state, [2, 2], ["dp", "sp"], cfg=W.FSDP_CFG)
    try:
        assert step.seq_axis is None
        got = W.cp_train(step, ids.astype(np.int64),
                         labels.astype(np.int64), STEPS)["losses"]
    finally:
        step.close()
        torch.set_num_threads(threads)
    np.testing.assert_allclose(got, jl, rtol=1e-5)
