"""The port's 4D hybrid (``parallel/hybrid.py``) on the CPU against the JAX
package's (``paddlepaddle_tpu/parallel/hybrid.py``):

* one rank: ``make_llama_block``, ``make_vocab_parallel_head`` and
  ``make_moe_block`` (all axes off) on the JAX weights (numpy, carried by
  ``convert.convert_pytree``): outputs, losses and gradients within rtol
  1e-5 of the JAX functions' (at each tensor's scale); the port block against the port's own
  ``LlamaDecoderLayer`` (rtol 2e-5, as ``tests/test_hybrid_4d.py:119``);
* eight gloo ranks from the port's ``spawn`` (one job, rank body
  ``tests/torch_dist_workers.py:hybrid_session``) over the meshes of
  ``tests/test_hybrid_4d.py:69-298``: ``dp1 fsdp2 tp2 pp2`` under 1F1B
  and ZBH1, ``dp2 fsdp1 tp2 pp2`` under 1F1B, the V=2 interleaved
  and ZBVPP schedules (four virtual stages), two layers a stage, the
  MoE stage on ``dp1 fsdp1 ep2 tp2 pp2``, and the 5-D mesh ``dp1 fsdp1
  sp2 tp2 pp2`` of ``tests/test_hybrid_4d.py:196`` (``sp_axis`` blocks
  and head, ``seq_axis`` in the executor: allgather-KV context-parallel
  attention and the label shift across the blocks): loss (rtol 1e-4),
  stage, head and input-cotangent gradients (rtol 2e-3, atol 2e-4) on
  every rank against the JAX unsharded oracle's (``reference_forward`` /
  the MoE chain);
* the context-parallel attention block by block: the port's blockwise
  attention and its prefix form (one causal flash call over the gathered
  prefix, the card's route) against the JAX ``_sp_blockwise_attention``
  on two sequence blocks; the ``max_seq_len`` check; specs and init
  shapes as the reference's.
"""

import pickle
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlepaddle_tpu.parallel import hybrid as JH
from paddlepaddle_tpu.parallel import pipeline_spmd as JS

import torch_dist_workers as W
from paddlepaddle_tpu_torch.convert import convert_pytree
from paddlepaddle_tpu_torch.distributed import ProcessMesh, spawn
from paddlepaddle_tpu_torch.parallel import hybrid as TH
from paddlepaddle_tpu_torch.parallel import pipeline_spmd as TS

CFG = dict(hidden_size=32, intermediate_size=64, num_heads=4, num_kv_heads=2,
           layers_per_stage=1, vocab_size=64, max_seq_len=16)
JCFG, TCFG = JH.HybridStageConfig(**CFG), TH.HybridStageConfig(**CFG)
D4 = ["dp", "fsdp", "tp", "pp"]
MOE = {"E": 4, "topk": 2, "cf": 8.0, "ep_size": 2, "eh": 48}
SP = {"sp": 2}
# (key, layers per stage, seed, schedule, V, mesh shape, names, moe or the
# sequence axis's size)
CASES = [
    ("dp1fsdp2 1f1b", 1, 0, "1f1b", 1, [1, 2, 2, 2], D4, None),
    ("dp2fsdp1 1f1b", 1, 0, "1f1b", 1, [2, 1, 2, 2], D4, None),
    ("dp1fsdp2 zbh1", 1, 0, "zbh1", 1, [1, 2, 2, 2], D4, None),
    ("interleaved", 1, 1, "interleaved", 2, [1, 2, 2, 2], D4, None),
    ("zbvpp", 1, 3, "zbvpp", 2, [1, 2, 2, 2], D4, None),
    ("two layers a stage", 2, 7, "1f1b", 1, [1, 2, 2, 2], D4, None),
    ("moe ep2tp2pp2", 1, 4, "1f1b", 1, [1, 1, 2, 2, 2],
     ["dp", "fsdp", "ep", "tp", "pp"], MOE),
    ("5d sp2tp2pp2", 1, 2, "1f1b", 1, [1, 1, 2, 2, 2],
     ["dp", "fsdp", "sp", "tp", "pp"], SP),
]


def _cfg(layers):
    return JCFG._replace(layers_per_stage=layers)


def _problem(n_stages, seed, cfg, moe=None):
    """The reference test's problem (tests/test_hybrid_4d.py:40 and
    :243), as numpy."""
    if moe and "E" in moe:
        keys = jax.random.split(jax.random.PRNGKey(seed), 5)
        stages = [JH.init_moe_stage(cfg, keys[i], moe["E"], moe["eh"])
                  for i in range(n_stages)]
        head = JH.init_llama_head(cfg, keys[2])
        embed = jax.random.normal(keys[3], (cfg.vocab_size, cfg.hidden_size),
                                  jnp.float32)
        ids = jax.random.randint(keys[4], (8, 16), 0, cfg.vocab_size,
                                 jnp.int32)
    else:
        keys = jax.random.split(jax.random.PRNGKey(seed), n_stages + 3)
        stages = [JH.init_llama_stage(cfg, keys[i]) for i in range(n_stages)]
        head = JH.init_llama_head(cfg, keys[n_stages])
        embed = jax.random.normal(keys[n_stages + 1],
                                  (cfg.vocab_size, cfg.hidden_size),
                                  jnp.float32)
        ids = jax.random.randint(keys[n_stages + 2], (8, 16), 0,
                                 cfg.vocab_size, jnp.int32)
    return stages, head, embed[ids], ids


def _oracle(cfg, stages, head, acts, ids, moe):
    if moe and "E" in moe:
        block = JH.make_moe_block(cfg, moe["E"], topk=moe["topk"],
                                  capacity_factor=moe["cf"], tp_axis=None,
                                  fsdp_axis=None, ep_axis=None, ep_size=1,
                                  remat=False)
        hfn = JH.make_vocab_parallel_head(cfg, tp_axis=None)

        def f(st, hp, a):
            x = a
            for sp in st:
                x = block(sp, x)
            return hfn(hp, x, ids)
    else:
        def f(st, hp, a):
            return JH.reference_forward(cfg, st, hp, a, ids)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(stages, head,
                                                             acts)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """The port's eight ranks run in a thread while this process computes
    the JAX oracles."""
    problems, cases = {}, []
    for key, layers, seed, sched, V, shape, names, moe in CASES:
        cfg = _cfg(layers)
        if (layers, seed, V) not in problems:   # the cases that share one
            problems[(layers, seed, V)] = (cfg,) + tuple(
                _problem(2 * V, seed, cfg, moe)) + (moe,)
        _, stages, head, acts, ids, _ = problems[(layers, seed, V)]
        stack = (JS.stack_stage_params if V == 1
                 else lambda t: JS.stack_virtual_stage_params(t, 2))
        cases.append((key, dict(CFG, layers_per_stage=layers),
                      _np(stack(stages)), _np(head), np.asarray(acts),
                      np.asarray(ids), sched, V, shape, names,
                      moe if moe is None or "E" not in moe
                      else {k: moe[k] for k in ("E", "topk", "cf",
                                                "ep_size")}))
    # through a file: a large argument makes the ranks start one by one
    # (each rank's start blocks until the one before has read its pipe)
    path = tmp_path_factory.mktemp("hybrid") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    job = {}

    def run():
        try:
            job["ranks"] = spawn(W.hybrid_session, args=(str(path),),
                                 nprocs=8, timeout=300, pg_timeout=120)
        except BaseException as e:  # noqa: BLE001 — raised below
            job["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    # the oracles compile in four threads (XLA lets go of the GIL)
    with ThreadPoolExecutor(4) as pool:
        oracles = dict(zip(problems, pool.map(lambda p: _oracle(*p),
                                              problems.values())))
    thread.join()
    if "error" in job:
        raise job["error"]
    ref = {}
    for key, layers, seed, sched, V, shape, names, moe in CASES:
        loss, (g_st, g_h, g_a) = oracles[(layers, seed, V)]
        stack = (JS.stack_stage_params if V == 1
                 else lambda t: JS.stack_virtual_stage_params(t, 2))
        ref[key] = (float(loss), _np(stack(g_st)), _np(g_h), np.asarray(g_a))
    return ref, job["ranks"]


def _scaled_close(got, want, rtol=1e-5, err_msg=""):
    """Within ``rtol`` of the reference at the reference tensor's scale:
    f32 sums in another order differ by a few ulps of the tensor's
    largest entries, which is past ``rtol`` of an entry near zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _close(got, want, what, rtol=2e-3, atol=2e-4):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}[{k}]", rtol, atol)
        return
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_hybrid_matches_the_unsharded_oracle(hybrid, key):
    ref, ranks = hybrid
    loss, g_st, g_h, g_a = ref[key]
    for r, got in enumerate(ranks):
        got = got[key]
        np.testing.assert_allclose(got[0], loss, rtol=1e-4)
        _close(got[1], g_st, f"rank {r} stage grads")
        _close(got[2], g_h, f"rank {r} head grads")
        _close(got[3], g_a, f"rank {r} embed cotangent")


# ---------------------------------------------------------------------------
# one rank against the JAX functions
# ---------------------------------------------------------------------------


def _one_rank_case(layers=2, seed=0, moe=None):
    cfg = _cfg(layers)
    stages, head, acts, ids = _problem(1, seed, cfg, moe)
    return cfg, _np(stages[0]), _np(head), np.asarray(acts), np.asarray(ids)


@pytest.mark.parametrize("remat", [False, True])
def test_one_rank_llama_block_matches_the_reference(remat):
    cfg, st, _, acts, _ = _one_rank_case()
    jb = JH.make_llama_block(cfg, tp_axis=None, fsdp_axis=None, remat=remat)
    tb = TH.make_llama_block(TH.HybridStageConfig(*cfg), tp_axis=None,
                             fsdp_axis=None, remat=remat)
    cot = np.random.default_rng(1).standard_normal(acts.shape).astype(
        np.float32)

    def jf(p, a):
        return jnp.sum(jb(p, a) * cot)

    jout = np.asarray(jax.jit(jb)(st, jnp.asarray(acts)))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(st, jnp.asarray(acts))
    p = {k: v.requires_grad_() for k, v in convert_pytree(st).items()}
    a = torch.from_numpy(acts.copy()).requires_grad_()
    out = tb(p, a)
    (out * torch.from_numpy(cot)).sum().backward()
    _scaled_close(out.detach().numpy(), jout)
    for k in st:
        _scaled_close(p[k].grad.numpy(), jg[0][k], err_msg=k)
    _scaled_close(a.grad.numpy(), jg[1])


def test_one_rank_head_matches_the_reference():
    cfg, _, head, acts, ids = _one_rank_case()
    jh = JH.make_vocab_parallel_head(cfg, tp_axis=None)
    th = TH.make_vocab_parallel_head(TH.HybridStageConfig(*cfg), tp_axis=None)
    ids = ids.copy()
    ids[0, 3] = -100                    # a masked label
    jl, jg = jax.jit(jax.value_and_grad(jh, argnums=(0, 1)))(
        head, jnp.asarray(acts), jnp.asarray(ids))
    hp = {k: v.requires_grad_() for k, v in convert_pytree(head).items()}
    a = torch.from_numpy(acts.copy()).requires_grad_()
    loss = th(hp, a, torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in head:
        _scaled_close(hp[k].grad.numpy(), jg[0][k], err_msg=k)
    _scaled_close(a.grad.numpy(), jg[1])


@pytest.mark.parametrize("topk,aux", [(2, 0.0), (1, 0.01)])
def test_one_rank_moe_block_matches_the_reference(topk, aux):
    moe = dict(MOE, topk=topk)
    cfg, st, _, acts, _ = _one_rank_case(layers=1, seed=4, moe=moe)
    kw = dict(topk=topk, capacity_factor=2.0, tp_axis=None, fsdp_axis=None,
              ep_axis=None, ep_size=1, aux_loss_weight=aux, remat=False)
    jb = JH.make_moe_block(cfg, moe["E"], **kw)
    tb = TH.make_moe_block(TH.HybridStageConfig(*cfg), moe["E"], **kw)
    cot = np.random.default_rng(2).standard_normal(acts.shape).astype(
        np.float32)
    jout = np.asarray(jax.jit(jb)(st, jnp.asarray(acts)))
    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(jb(p, jnp.asarray(acts)) * cot)))(st)
    p = {k: v.requires_grad_() for k, v in convert_pytree(st).items()}
    out = tb(p, torch.from_numpy(acts))
    (out * torch.from_numpy(cot)).sum().backward()
    _scaled_close(out.detach().numpy(), jout)
    for k in st:
        _scaled_close(p[k].grad.numpy(), jg[k], err_msg=k)


def test_hybrid_block_matches_llama_decoder_layer():
    """The functional stage block IS the Llama math: one unsharded layer
    against the port's ``LlamaDecoderLayer`` on the same weights."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                                     rope_tables)

    lcfg = pt.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=4,
                          num_key_value_heads=2, max_position_embeddings=16)
    torch.manual_seed(0)
    layer = LlamaDecoderLayer(lcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn_like(p) * 0.2 + (1.0 if p.dim() == 1 else 0))
    sp = {"ln1": layer.input_layernorm.weight,
          "ln2": layer.post_attention_layernorm.weight,
          "wq": layer.self_attn.q_proj.weight,
          "wk": layer.self_attn.k_proj.weight,
          "wv": layer.self_attn.v_proj.weight,
          "wo": layer.self_attn.o_proj.weight,
          "wg": layer.mlp.gate_proj.weight, "wu": layer.mlp.up_proj.weight,
          "wd": layer.mlp.down_proj.weight}
    sp = {k: v.detach()[None] for k, v in sp.items()}
    block = TH.make_llama_block(TCFG, tp_axis=None, fsdp_axis=None,
                                remat=False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 32)).astype(np.float32))
    cos, sin = rope_tables(8, 16, 10000.0)
    with torch.no_grad():
        want = layer(x, cos, sin)
        got = block(sp, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_specs_and_init_shapes_match_the_reference():
    def tup(spec):
        return tuple(spec)

    for t, j in ((TH.llama_stage_specs(), JH.llama_stage_specs()),
                 (TH.llama_head_specs(), JH.llama_head_specs()),
                 (TH.moe_stage_specs(), JH.moe_stage_specs())):
        assert t == {k: tup(v) for k, v in j.items()}
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for t, j in ((TH.init_llama_stage(TCFG, g), JH.init_llama_stage(JCFG, key)),
                 (TH.init_llama_head(TCFG, g), JH.init_llama_head(JCFG, key)),
                 (TH.init_moe_stage(TCFG, g, 4, 48),
                  JH.init_moe_stage(JCFG, key, 4, 48))):
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
        assert all(v.dtype == torch.float32 for v in t.values())
    bf = TH.init_llama_stage(TCFG, g, torch.bfloat16)
    assert bf["wq"].dtype == torch.bfloat16
    # a seeded generator draws the same weights again
    a = TH.init_llama_stage(TCFG, torch.Generator().manual_seed(5))
    b = TH.init_llama_stage(TCFG, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert TCFG.head_dim == JCFG.head_dim == 8


def _jax_two_blocks(fn, *arrays):
    """``fn`` on the two sequence blocks of a JAX ``sp2`` mesh (two of the
    eight virtual devices) over whole arrays sharded on dim 1."""
    from jax.sharding import Mesh, PartitionSpec as P

    from paddlepaddle_tpu.core.jax_compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    spec = P(None, "sp")
    return shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                     out_specs=spec, check_vma=False)(*arrays)


def test_context_parallel_attention_matches_the_reference_blocks():
    """The port's ``_sp_blockwise_attention`` (plain) and
    ``_sp_prefix_attention`` (the card's one causal flash call over the
    gathered prefix; here the flash wrappers' plain version) on each of
    two sequence blocks against the JAX ``_sp_blockwise_attention`` under
    ``shard_map`` over two devices: outputs and the q, k, v gradients at
    rtol 1e-5 (each tensor's scale). The gather is the whole K/V, which is
    what the all-gather over ``sp`` gives each block."""
    rng = np.random.default_rng(3)
    b, s, h, kvh, d = 2, 16, 4, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    def jf(q_, k_, v_):
        return JH._sp_blockwise_attention(q_, k_, v_, "sp", 2, scale, rep=2)

    def jloss(q_, k_, v_):
        return jnp.sum(_jax_two_blocks(jf, q_, k_, v_) * cot)

    jout = np.asarray(_jax_two_blocks(jf, q, k, v))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for route in ("blockwise", "prefix"):
        qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_()
                      for a in (q, k, v))
        outs = []
        for r in range(2):
            qr = qt.chunk(2, dim=1)[r]
            with _TwoBlockGather(kt, vt, r):
                if route == "blockwise":
                    outs.append(TH._sp_blockwise_attention(
                        qr, kt.chunk(2, 1)[r], vt.chunk(2, 1)[r], "sp", 2,
                        float(scale), rep=2))
                else:
                    outs.append(TH._sp_prefix_attention(
                        qr, kt.chunk(2, 1)[r], vt.chunk(2, 1)[r], "sp", 2))
        out = torch.cat(outs, dim=1)
        (out * torch.from_numpy(cot)).sum().backward()
        _scaled_close(out.detach().numpy(), jout, err_msg=route)
        for name, t, want in (("q", qt, jg[0]), ("k", kt, jg[1]),
                              ("v", vt, jg[2])):
            _scaled_close(t.grad.numpy(), want, err_msg=f"{route} d{name}")


class _TwoBlockGather:
    """Block ``r`` of a two-rank ``sp`` axis inside one process: the
    all-gather of K/V over ``sp`` is the whole tensor (the other block is
    the same data a second rank would hold, and the gradient that the
    gather's reduce-scatter would return flows into the whole tensor
    here), and the axis index is ``r``."""

    def __init__(self, k, v, r):
        self.by_shape = {}
        self.k, self.v, self.r = k, v, r

    def __enter__(self):
        from paddlepaddle_tpu_torch.distributed import collective as C

        self._saved = (C.f_all_gather, C.f_axis_index)
        k, v, r = self.k, self.v, self.r

        def gather(x, axis, concat_axis=0, tiled=True):
            for whole in (k, v):
                if x.data_ptr() == whole.chunk(2, 1)[r].data_ptr():
                    return whole
            raise AssertionError("gathered an unexpected tensor")

        C.f_all_gather = gather
        C.f_axis_index = lambda axis: r
        return self

    def __exit__(self, *exc):
        from paddlepaddle_tpu_torch.distributed import collective as C

        C.f_all_gather, C.f_axis_index = self._saved


def test_context_parallel_raises_naming_the_later_slice():
    """The context-parallel branch runs since A10 slice 5 (its parity
    cases: the 5-D arm of the eight-rank job and the block test above);
    what it still raises is the reference's loud check (:485-492): a
    global sequence past ``max_seq_len`` raises, never clamps."""
    block = TH.make_llama_block(TCFG, tp_axis=None, fsdp_axis=None,
                                sp_axis="sp", sp_size=4, remat=False)
    st = convert_pytree(_np(JH.init_llama_stage(JCFG, jax.random.PRNGKey(0))))
    with _TwoBlockGather(torch.zeros(1), torch.zeros(1), 0):
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            block(st, torch.zeros(1, 8, 32))


def test_moe_block_refuses_a_bad_ep_size():
    with pytest.raises(ValueError, match="ep_size"):
        TH.make_moe_block(TCFG, 4, ep_axis="ep", ep_size=1)
    with pytest.raises(ValueError, match="not divisible"):
        TH.make_moe_block(TCFG, 5, ep_axis="ep", ep_size=2)
