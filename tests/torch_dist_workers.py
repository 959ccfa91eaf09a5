"""Rank bodies for the port's multi-process CPU tests
(``tests/test_torch_shard_plan.py``, ``tests/test_torch_sharded_train.py``,
``tests/test_torch_distributed.py``).

Each function runs in one process of a ``paddlepaddle_tpu_torch.distributed
.spawn`` job over gloo on the CPU and returns plain Python / numpy values
for the test process to compare. This module imports neither JAX nor the
JAX package, so the spawned ranks never load them; the tests compute the
JAX side in their own process and pass weights in as numpy.
"""

import time

import numpy as np
import torch

from paddlepaddle_tpu_torch.optimizer import AdamW as _PortAdamW
from paddlepaddle_tpu_torch.optimizer import Momentum as _PortMomentum
from paddlepaddle_tpu_torch.parallel.moe import NaiveGate as _PortGate
from paddlepaddle_tpu_torch.parallel.moe import _topk_routing

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=192,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=96)
# 2 KV heads a rank under mp2
TINY_GQA = dict(TINY, num_attention_heads=8, num_key_value_heads=4)


def _init(backend="gloo"):
    from paddlepaddle_tpu_torch.distributed import get_rank, init_parallel_env

    init_parallel_env(backend=backend)
    return get_rank()


def port_llama(state, dtype, cfg=None):
    """A port Llama on the CPU holding ``state`` (numpy f32 arrays)."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.convert import load_jax_state

    model = pt.LlamaForCausalLM(pt.LlamaConfig(**dict(cfg or TINY,
                                                      dtype=dtype)),
                                device="cpu")
    load_jax_state(model, state)
    return model


def _requests(prompts, n, prefix_len=None):
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest

    return [GenerationRequest(p, n, prefix_len=prefix_len) for p in prompts]


def _serve(model, prompts, n, plan=None, quant=None, prefix_len=None,
           prefix=True):
    """Greedy tokens of the reference test's engine (2 slots, chunk 4,
    page 16) on the driver; the follower's loop elsewhere. Returns (tokens
    or None, engine)."""
    import paddlepaddle_tpu_torch as pt

    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               plan=plan, quant=quant, prefix_cache=prefix,
                               device="cpu")
    if not eng.is_driver:
        eng.follow()
        return None, eng
    reqs = _requests(prompts, n, prefix_len)
    eng.serve(reqs, timeout=300)
    eng.stop()
    return [np.asarray(r.result.result(5)) for r in reqs], eng


def decode_session(states, prompts, pfx_prompts):
    """TP-2 decode on two ranks: f32 and bf16 tokens and first-step logits
    beside the one-process engine, f32 at 2 KV heads a rank, int8 weights, prefix hits, the KV pool's
    local shape, and ``ServingEngine(mesh="mp2")``."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _init()
    out = {"rank": rank}
    for dtype in ("float32", "bfloat16"):
        model = port_llama(states[dtype], dtype)
        toks, eng = _serve(model, prompts, 12, plan=decode_plan("mp2"))
        out[f"tp_{dtype}"] = toks
        out[f"pool_{dtype}"] = tuple(eng.caches[0][0].shape)
        out[f"capture_{dtype}"] = eng.capture_info()
        # first-step logits through the rank's sharded view (gathered)
        with torch.no_grad():
            tp_logits = [eng.net(torch.from_numpy(p[None]).long())[0, -1]
                         .float().numpy() for p in prompts]
            one_logits = [model(torch.from_numpy(p[None]).long())[0, -1]
                          .float().numpy() for p in prompts]
        out[f"logit_diff_{dtype}"] = max(
            float(np.abs(a - b).max()) for a, b in zip(tp_logits, one_logits))
        out[f"logit_scale_{dtype}"] = max(float(np.abs(b).max())
                                          for b in one_logits)
        if rank == 0:
            out[f"one_{dtype}"], _ = _serve(model, prompts, 12)
    model = port_llama(states["gqa"], "float32", TINY_GQA)
    out["tp_gqa"], eng = _serve(model, prompts, 12, plan=decode_plan("mp2"))
    out["pool_gqa"] = tuple(eng.caches[0][0].shape)
    if rank == 0:
        out["one_gqa"], _ = _serve(model, prompts, 12)
    model = port_llama(states["bfloat16"], "bfloat16")
    out["tp_int8"], eng = _serve(model, prompts, 12, plan=decode_plan("mp2"),
                                 quant="weight_only_int8")
    q = eng.net.model.layers[0].self_attn.q_proj
    out["int8_q_shape"] = tuple(q.quant_weight.shape)
    if rank == 0:
        out["one_int8"], _ = _serve(model, prompts, 12,
                                    quant="weight_only_int8")
    for prefix in (True, False):
        toks, eng = _serve(model, pfx_prompts, 8, plan=decode_plan("mp2"),
                           prefix_len=20 if prefix else None, prefix=prefix)
        out[f"pfx_{prefix}"] = toks
        out[f"pfx_stats_{prefix}"] = (eng.prefix.hits, eng.prefix.misses)
    obs.reset()
    model = port_llama(states["float32"], "float32")
    with pt.ServingEngine(model, max_batch_size=2, decode_chunk=4,
                          kv_page_size=16, mesh="mp2", device="cpu") as srv:
        if srv.is_driver:
            out["serving_out"] = srv.generate(
                np.arange(8, dtype=np.int32), max_new_tokens=4, timeout=120)
        out["health_mesh"] = srv.health()["mesh"]
        out["drain"] = srv.drain(timeout=30)["clean"]
    snap = obs.snapshot()
    out["gauges"] = {k: dict(snap.get(k, {})) for k in
                     ("paddle_tp_degree", "paddle_mesh_devices",
                      "paddle_mesh_axes")}
    return out


def spmd_tokens_session(cases, prompts, n):
    """TP-2 greedy tokens of the launcher form (one engine a rank) for each
    ``(label, state, dtype, cfg, quant)`` case; rank 0 returns
    ``{label: tokens}``, rank 1 None. The single-process engine's tokens
    are held against these to the bit."""
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _init()
    out = {}
    for label, state, dtype, cfg, quant in cases:
        model = port_llama(state, dtype, cfg)
        out[label], _ = _serve(model, prompts, n, plan=decode_plan("mp2"),
                               quant=quant)
    return out if rank == 0 else None


def follower_fault_session(state, prompts, report_dir):
    """TP-2 decode where the follower fails alone: first an unservable
    request (both ranks raise ``ValueError`` and go on), then a fault
    injected into the follower's third paged forward. The follower dies
    (``os._exit``, as a killed process would, without a result); rank 0
    must raise out of ``serve`` instead of waiting out the process-group
    timeout. Each rank writes what it saw to ``report_dir/rank<r>.json``."""
    import json
    import os

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _init()
    model = port_llama(state, "float32")
    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               plan=decode_plan("mp2"), device="cpu")
    too_long = np.zeros((TINY["max_position_embeddings"],), np.int32)
    report = {"rank": rank}

    def write():
        with open(os.path.join(report_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)

    if not eng.is_driver:
        real, calls = eng._forward_paged, [0]

        def faulty(*a, **k):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("injected follower fault")
            return real(*a, **k)

        eng._forward_paged = faulty
        try:
            eng.follow()
            report["follower"] = "returned"
        except RuntimeError as e:
            report["follower"] = str(e)
        write()
        os._exit(3)
    reqs = _requests([too_long], 12) + _requests(prompts, 12)
    t0 = time.monotonic()
    try:
        eng.serve(reqs, timeout=60)
        report["driver"] = "served"
    except Exception as e:  # noqa: BLE001 — what the test reads
        report["driver"] = f"{type(e).__name__}: {e}"
    report["driver_s"] = time.monotonic() - t0
    report["too_long"] = repr(reqs[0].result._error)
    write()
    return report


def train_session(state, ids, labels, spec, clip):
    """``ShardedTrainStep`` over ``spec`` for two steps: the losses, and on
    rank 0 the one-process ``TrainStep``'s losses and the largest
    difference of every synced parameter from it."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    rank = _init()
    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64)

    def loss_fn(m, i, l):  # noqa: E741
        return m(i, labels=l)

    def opt(m):
        return pt.AdamW(learning_rate=1e-3, parameters=m.parameters(),
                        grad_clip=pt.ClipGradByGlobalNorm(clip)
                        if clip else None)

    m2 = port_llama(state, "float32", cfg)
    step = ShardedTrainStep(m2, opt(m2), loss_fn,
                            plan=train_plan(spec, data_axes=("dp",)))
    ids_t, lab_t = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    out = {"rank": rank, "losses": [float(step(ids_t, lab_t))
                                    for _ in range(2)],
           "local_shapes": {n: tuple(p.shape)
                            for n, p in step.params.items()}}
    step.sync_to_model()
    # a loss that never reports its token count cannot be the global mean
    m3 = port_llama(state, "float32", cfg)
    blind = ShardedTrainStep(m3, opt(m3),
                             lambda m, i, l: m(i).float().square().mean(),
                             plan=train_plan(spec, data_axes=("dp",)))
    try:
        blind(ids_t, lab_t)
        out["blind_loss"] = "accepted"
    except NotImplementedError as e:
        out["blind_loss"] = str(e)
    if rank == 0:
        m1 = port_llama(state, "float32", cfg)
        s1 = pt.TrainStep(m1, opt(m1), loss_fn, device="cpu")
        out["one_losses"] = [float(s1(ids_t, lab_t)) for _ in range(2)]
        ref = dict(m1.named_parameters())
        out["param_diff"] = {n: float((p.detach() - ref[n].detach())
                                      .abs().max())
                             for n, p in m2.named_parameters()}
    return out


def _fd_check(fn, x, w, pg_all, eps=1e-6, picks=3):
    """Analytic gradient of J = sum over ranks of <w_r, fn(x_r)> against
    central finite differences at ``picks`` elements owned by each rank in
    turn (every rank evaluates J for every perturbation, in step)."""
    import torch.distributed as dist

    from paddlepaddle_tpu_torch.distributed.collective import _all_reduce_

    me, n = dist.get_rank(), dist.get_world_size()
    xg = x.clone().requires_grad_(True)
    (fn(xg) * w).sum().backward()
    worst = 0.0

    def J(xv):
        with torch.no_grad():
            j = (fn(xv) * w).sum().reshape(1)
        return float(_all_reduce_(j, "sum", pg_all)[0])

    for owner in range(n):
        for k in range(picks):
            idx = (k * 7) % x.numel()
            d = torch.zeros_like(x).reshape(-1)
            if me == owner:
                d[idx] = eps
            d = d.reshape(x.shape)
            fd = (J(x + d) - J(x - d)) / (2 * eps)
            if me == owner:
                grad = (torch.zeros_like(x) if xg.grad is None
                        else xg.grad).reshape(-1)
                worst = max(worst, abs(fd - float(grad[idx])))
    return worst


def collectives_session():
    """Eager collectives, ``f_*`` gradients, the Megatron pair, mesh groups,
    host collectives over the store and ``DataParallel`` on two ranks."""
    import torch.distributed as dist

    import paddlepaddle_tpu_torch.distributed as D
    from paddlepaddle_tpu_torch.distributed import collective as C
    from paddlepaddle_tpu_torch.distributed.host_collectives import \
        get_host_group
    from paddlepaddle_tpu_torch.parallel import (ColumnParallelLinear,
                                                 ParallelCrossEntropy,
                                                 RowParallelLinear,
                                                 VocabParallelEmbedding)

    rank = _init()
    out = {"rank": rank, "world": D.get_world_size()}
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    t = base.clone()
    D.all_reduce(t)
    out["all_reduce"] = t.numpy()
    t = base.clone()
    D.all_reduce(t, op=D.ReduceOp.MAX)
    out["all_reduce_max"] = t.numpy()
    t = base.clone()
    D.all_reduce(t, op=D.ReduceOp.AVG)
    out["all_reduce_avg"] = t.numpy()
    lst = []
    D.all_gather(lst, base.clone())
    out["all_gather"] = [x.numpy() for x in lst]
    t = base.clone()
    D.broadcast(t, src=1)
    out["broadcast"] = t.numpy()
    t = torch.empty(3)
    D.reduce_scatter(t, [base[0].clone(), base[1].clone()])
    out["reduce_scatter"] = t.numpy()
    o = []
    D.all_to_all(o, [base[0].clone(), base[1].clone()])
    out["all_to_all"] = [x.numpy() for x in o]
    t = torch.empty(3)
    D.scatter(t, [base[0].clone(), base[1].clone()] if rank == 0 else None,
              src=0)
    out["scatter"] = t.numpy()
    objs = []
    D.all_gather_object(objs, {"r": rank})
    out["objects"] = objs
    hb = (torch.ones(4) * (rank + 1) / 3).to(torch.bfloat16)
    D.all_reduce(hb)
    out["bf16_sum"] = hb.float().numpy()
    hg = []
    D.all_gather(hg, torch.full((2,), 1.0 + rank / 3).to(torch.bfloat16))
    out["bf16_gather"] = [x.float().numpy() for x in hg]
    peer = 1 - rank
    buf = torch.zeros(3)
    if rank == 0:
        D.send(torch.tensor([1.0, 2.0, 3.0]), dst=1)
        D.recv(buf, src=1)
    else:
        D.recv(buf, src=0)
        D.send(buf * 2, dst=0)
    out["p2p"] = buf.numpy()
    r_buf = torch.zeros(2)
    tasks = D.batch_isend_irecv([
        D.P2POp(D.isend, torch.full((2,), float(rank)), peer),
        D.P2POp("irecv", r_buf, peer)])
    out["batch_p2p"] = (r_buf.numpy(), all(t.is_completed() for t in tasks))
    D.barrier()
    # f_* gradients over a mesh axis against finite differences (f64)
    mesh = D.ProcessMesh([[0, 1]], dim_names=["dp", "mp"])
    D.set_mesh(mesh)
    out["mp_slice"] = mesh.slice_ranks("mp", rank)
    dm = mesh.device_mesh("cpu")
    out["device_mesh"] = (tuple(dm.mesh_dim_names), tuple(dm.mesh.shape))
    out["dp_slice"] = mesh.slice_ranks("dp", rank)
    out["axis_index"] = (C.f_axis_index("mp"), C.f_axis_index("dp"))
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(4, 6, generator=g, dtype=torch.float64)
    pg = dist.group.WORLD
    fd = {}
    fd["f_all_reduce"] = _fd_check(
        lambda v: C.f_all_reduce(v, "mp"), x,
        torch.randn(4, 6, generator=g, dtype=torch.float64), pg)
    fd["f_all_gather"] = _fd_check(
        lambda v: C.f_all_gather(v, "mp", concat_axis=1), x,
        torch.randn(4, 12, generator=g, dtype=torch.float64), pg)
    fd["f_reduce_scatter"] = _fd_check(
        lambda v: C.f_reduce_scatter(v, "mp", scatter_axis=0), x,
        torch.randn(2, 6, generator=g, dtype=torch.float64), pg)
    fd["f_all_to_all"] = _fd_check(
        lambda v: C.f_all_to_all(v, "mp", split_axis=1, concat_axis=0), x,
        torch.randn(8, 3, generator=g, dtype=torch.float64), pg)
    fd["f_broadcast"] = _fd_check(
        lambda v: C.f_broadcast(v, "mp", root=1), x,
        torch.randn(4, 6, generator=g, dtype=torch.float64), pg)
    fd["f_ppermute"] = _fd_check(
        lambda v: C.f_ppermute(v, "mp", [(0, 1), (1, 0)]), x,
        torch.randn(4, 6, generator=g, dtype=torch.float64), pg)
    out["fd"] = fd
    out["f_all_reduce_value"] = C.f_all_reduce(
        torch.full((2,), float(rank + 1)), "mp").numpy()
    # the Megatron layers against one rank's plain computation
    torch.manual_seed(0)
    from paddlepaddle_tpu_torch.core import random as prandom

    prandom.seed(11)
    col = ColumnParallelLinear(8, 6, has_bias=True, gather_output=False,
                               device="cpu")
    prandom.seed(12)
    row = RowParallelLinear(6, 5, has_bias=True, input_is_parallel=True,
                            device="cpu")
    xin = torch.randn(3, 8, generator=torch.Generator().manual_seed(5),
                      requires_grad=True)
    y = row(col(xin))
    y.square().sum().backward()
    full_w1 = C._all_gather(col.weight.detach(), pg, 1)
    full_b1 = C._all_gather(col.bias.detach(), pg, 0)
    full_w2 = C._all_gather(row.weight.detach(), pg, 0)
    xr = xin.detach().clone().requires_grad_(True)
    yr = (xr @ full_w1 + full_b1) @ full_w2 + row.bias.detach()
    yr.square().sum().backward()
    out["mlp_diff"] = (float((y - yr).abs().max()),
                       float((xin.grad - xr.grad).abs().max()))
    prandom.seed(13)
    emb = VocabParallelEmbedding(10, 4, device="cpu")
    ids = torch.tensor([[0, 3, 9, 5]])
    full_e = C._all_gather(emb.weight.detach(), pg, 0)
    out["vocab_emb_diff"] = float((emb(ids) - full_e[ids]).abs().max())
    logits_full = torch.randn(5, 10, generator=torch.Generator()
                              .manual_seed(7), dtype=torch.float64)
    local = logits_full.chunk(2, dim=1)[rank].clone().requires_grad_(True)
    lab = torch.tensor([0, 9, 4, -100, 6])
    ce = ParallelCrossEntropy()(local, lab)
    ce.sum().backward()
    ref_in = logits_full.clone().requires_grad_(True)
    ref = torch.nn.functional.cross_entropy(ref_in, lab, ignore_index=-100,
                                            reduction="none")
    ref.sum().backward()
    out["pce_diff"] = (float((ce[:, 0] - ref).abs().max()),
                       float((local.grad - ref_in.grad.chunk(2, 1)[rank])
                             .abs().max()))
    # host collectives over the store
    hg = get_host_group()
    out["host"] = (hg.all_reduce(np.array([rank + 1.0])).tolist(),
                   hg.broadcast(np.array([rank * 5]), src=1).tolist())
    hg.barrier()
    # DataParallel: averaged gradients equal the mean over both ranks' data
    lin = torch.nn.Linear(3, 1)
    with torch.no_grad():
        lin.weight.fill_(0.5)
        lin.bias.fill_(0.1)
    dp = D.DataParallel(lin)
    xb = torch.arange(6, dtype=torch.float32).reshape(2, 3) + rank
    dp(xb).sum().backward()
    out["dp_grad"] = lin.weight.grad.numpy().copy()
    with dp.no_sync():
        lin.weight.grad = None
        dp(xb).sum().backward()
    out["dp_no_sync_grad"] = lin.weight.grad.numpy().copy()
    # the stream variant returns a waitable task
    t = torch.ones(2) * (rank + 1)
    task = D.communication.stream.all_reduce(t, sync_op=False)
    out["stream"] = (task.wait(), t.numpy().copy())
    # the observability hook counts eager collectives
    from paddlepaddle_tpu_torch import observability as obs

    obs.enable(metrics=True)
    try:
        D.all_reduce(torch.ones(4))
        snap = obs.snapshot()
    finally:
        obs.disable()
    out["obs_calls"] = dict(snap.get("paddle_collective_calls_total", {}))
    return out


def dead_follower_session():
    """Rank 1 builds its TP engine and returns without following; rank 0's
    serve must raise (its peer's sockets are closed), never hang. Returns
    rank 0's error text."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _init()
    model = pt.LlamaForCausalLM(pt.LlamaConfig(**TINY), device="cpu")
    eng = pt.BatchDecodeEngine(model, max_slots=2, chunk=4, page_size=16,
                               plan=decode_plan("mp2"), device="cpu")
    if rank == 1:
        return None
    import time

    time.sleep(1.0)
    try:
        eng.serve(_requests([np.arange(9, dtype=np.int32)], 4), timeout=60)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return f"{type(e).__name__}: {e}"
    return "served"


def launched_script_body():
    """What a script under the launcher runs: join the job and all-reduce
    its rank."""
    from paddlepaddle_tpu_torch.distributed import all_reduce

    rank = _init()
    t = torch.tensor([float(rank + 1)])
    all_reduce(t)
    return rank, float(t[0])


# ---------------------------------------------------------------------------
# card bodies (tests/test_torch_distributed_card.py): ranks share cuda:0
# over gloo, or one NCCL rank
# ---------------------------------------------------------------------------

CARD = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def _card_counts():
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    return {"paged": pa.paged_attention.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "nvcc": _build.nvcc_runs}


def card_decode_session(dtype, backend, spec, prompts, n_new):
    """Greedy tokens of a ``spec`` plan's engine on the card (the driver's;
    None on a follower), this rank's paged launches and the decode steps
    they served, the capture info, and on rank 0 the plan-less engine's
    tokens and its capture info."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    rank = _init(backend)
    model = pt.LlamaForCausalLM(pt.LlamaConfig(**dict(CARD, dtype=dtype)),
                                seed=0)
    eng = pt.BatchDecodeEngine(model, max_slots=4, chunk=8, page_size=64,
                               max_len=512, plan=decode_plan(spec))
    pa.paged_attention.launches = 0
    out = {"rank": rank}
    if eng.is_driver:
        reqs = [GenerationRequest(p, n_new) for p in prompts]
        eng.serve(reqs, timeout=600)
        eng.stop()
        out["tokens"] = [np.asarray(r.result.result(5)) for r in reqs]
    else:
        eng.follow()
    out["paged"] = pa.paged_attention.launches
    out["steps"] = eng.stats["decode_steps"]
    out["capture"] = eng.capture_info()
    out["nvcc"] = _card_counts()["nvcc"]
    if rank == 0:
        one = pt.BatchDecodeEngine(model, max_slots=4, chunk=8, page_size=64,
                                   max_len=512)
        reqs = [GenerationRequest(p, n_new) for p in prompts]
        one.serve(reqs, timeout=600)
        out["one_tokens"] = [np.asarray(r.result.result(5)) for r in reqs]
        out["one_capture"] = one.capture_info()
    return out


def card_train_session(spec, n_steps=2):
    """``ShardedTrainStep`` over ``spec`` on the card (f32, head dim 128):
    losses, this rank's flash launches, and on rank 0 a one-process
    ``TrainStep``'s losses."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    rank = _init("gloo")
    cfg = pt.LlamaConfig(**CARD)

    def loss_fn(m, i, l):  # noqa: E741
        return m(i, labels=l)

    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, CARD["vocab_size"], (4, 128))).cuda()
    m2 = pt.LlamaForCausalLM(cfg, seed=1)
    step = ShardedTrainStep(m2, pt.AdamW(learning_rate=1e-3,
                                         parameters=m2.parameters()),
                            loss_fn, plan=train_plan(spec, data_axes=("dp",)))
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
    out = {"rank": rank, "losses": [float(step(ids, ids))
                                    for _ in range(n_steps)]}
    c = _card_counts()
    out["flash"] = {k: c[k] for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")}
    out["nvcc"] = c["nvcc"]
    if rank == 0:
        m1 = pt.LlamaForCausalLM(cfg, seed=1)
        s1 = pt.TrainStep(m1, pt.AdamW(learning_rate=1e-3,
                                       parameters=m1.parameters()), loss_fn)
        out["one_losses"] = [float(s1(ids, ids)) for _ in range(n_steps)]
    return out


# -- MoE under data and expert parallelism ------------------------------------

class TapAdamW(_PortAdamW):
    """The port's ``AdamW``, recording the gradients its first ``apply``
    receives (summed over ``dp``, before the clip) in ``first``, by name,
    as numpy, on each rank."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.first = {}

    def apply(self, grads=None, lr=None):
        if not self.first:
            self.first = {n: g.detach().float().cpu().numpy().copy()
                          for n, g in zip(self._names, grads)}
        return super().apply(grads, lr)


def port_moe(state, mode, capacity_factor):
    """The port's tiny MoE (``MoEConfig.tiny()``) on the CPU in dispatch
    ``mode`` holding ``state`` (the JAX model's, as numpy)."""
    import dataclasses

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.convert import load_jax_state

    cfg = dataclasses.replace(pt.MoEConfig.tiny(), dispatch_mode=mode,
                              capacity_factor=capacity_factor)
    model = pt.MoEForCausalLM(cfg, device="cpu")
    load_jax_state(model, state)
    return model


def moe_train(step, opt, ids, n_steps):
    """``n_steps`` of ``step`` on ``(ids, ids)``: the losses, the first
    gradients ``opt`` recorded and every parameter whole afterwards."""
    ids_t = torch.from_numpy(ids).long()
    losses = [float(step(ids_t, ids_t)) for _ in range(n_steps)]
    full = {n: t.float().cpu().numpy() for n, t in step.full_params().items()}
    return {"losses": losses, "grads": opt.first, "params": full}


def moe_dp_session(states, ids, capacity_factor, lr):
    """The SPMD form of the tiny MoE's ``ShardedTrainStep`` over ``dp2``,
    two AdamW steps in each dispatch mode (``states``: mode -> the JAX
    model's state): every rank's losses, first gradients and parameters
    after the steps."""
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    out = {"rank": _init()}
    for mode, state in states.items():
        model = port_moe(state, mode, capacity_factor)
        opt = TapAdamW(learning_rate=lr, parameters=model.parameters())
        step = ShardedTrainStep(model, opt, lambda m, i, l: m(i, labels=l),
                                plan=train_plan("dp2", data_axes=("dp",)))
        out[mode] = moe_train(step, opt, ids, 2)
    return out


class ScaledGate(_PortGate):
    """A custom gate: it overrides ``routing()`` (GShard top-k over twice
    the logits), so its layer takes the einsum route."""

    def routing(self, x_flat, capacity):
        logits = 2.0 * (x_flat.float() @ self.weight.float())
        return _topk_routing(logits, capacity, self.topk)


def with_scaled_gates(model):
    """``model`` with each MoE layer's gate swapped for a
    :class:`ScaledGate` holding the same weight."""
    for layer in model.layers:
        old = layer.mlp.gate
        new = ScaledGate(old.weight.shape[0], old.num_experts,
                         topk=old.topk, device=old.weight.device)
        with torch.no_grad():
            new.weight.copy_(old.weight)
        layer.mlp.gate = new
    return model


# -- the fsdp axis (ZeRO-3) and the sharding API ------------------------------

FSDP_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64)


def fsdp_case_step(case, model=None):
    """The port's ``ShardedTrainStep`` of one ``case`` of
    ``tests/test_torch_fsdp.py`` (a dict: ``state``, ``shape``, ``names``,
    ``rules``, ``data_axes``, ``p_g_os``, ``opt`` (``"adamw"`` with a
    global-norm clip at ``clip``, or ``"momentum"``), ``clip``, ``lr``),
    with its optimizer, over a Llama holding ``case["state"]``."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.distributed.sharding import \
        group_sharded_parallel
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    model = model or port_llama(case["state"], "float32", FSDP_CFG)
    if case["opt"] == "momentum":
        opt = pt.Momentum(learning_rate=case["lr"], momentum=0.9,
                          parameters=model.parameters())
    else:
        opt = pt.AdamW(learning_rate=case["lr"],
                       parameters=model.parameters(),
                       grad_clip=pt.ClipGradByGlobalNorm(case["clip"]))
    if case["p_g_os"]:
        model, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
    step = ShardedTrainStep(
        model, opt, lambda m, i, l: m(i, labels=l),
        mesh=ProcessMesh(shape=case["shape"], dim_names=case["names"]),
        rules=case["rules"], data_axes=case["data_axes"])
    return model, step


def fsdp_run(step, ids, labels, n_steps):
    """``n_steps`` losses, every parameter whole after them (numpy), and
    this rank's local shapes."""
    ids_t = torch.from_numpy(ids).long()
    lab_t = torch.from_numpy(labels).long()
    losses = [float(step(ids_t, lab_t)) for _ in range(n_steps)]
    full = {n: t.numpy().copy() for n, t in step.full_params().items()}
    shapes = {n: tuple(p.shape) for n, p in step.params.items()}
    return {"losses": losses, "params": full, "shapes": shapes}


def fsdp_session(cases, ids, labels, n_steps):
    """The SPMD form of each case (every case's mesh spans this job's
    ranks): losses, whole parameters (rank 0) and local shapes."""
    rank = _init()
    out = {}
    for name, case in cases.items():
        _, step = fsdp_case_step(case)
        run = fsdp_run(step, ids, labels, n_steps)
        if rank:
            run.pop("params")
        out[name] = run
    return out


def sharding_api_session(x, pairs, layer_state):
    """``shard_tensor`` then ``reshard`` on this job's ranks for each
    ``(mesh shape, names, src placements, dst placements)`` of ``pairs``
    (placements as ``("S", d)``, ``("R",)``, ``("P", op)``): the global
    value, its ``dist_attr`` and this rank's local block, and a default
    ``shard_layer`` of a Linear holding ``layer_state``: its output on
    ``x`` and its parameters' placements."""
    import paddlepaddle_tpu_torch.distributed as D
    from paddlepaddle_tpu_torch import nn

    rank = _init()

    def place(p):
        return {"S": lambda d: D.Shard(d), "R": lambda: D.Replicate(),
                "P": lambda op: D.Partial(op)}[p[0]](*p[1:])

    xt = torch.from_numpy(x)
    out = {"rank": rank, "pairs": []}
    for shape, names, src, dst in pairs:
        mesh = D.ProcessMesh(shape=shape, dim_names=names)
        a = D.shard_tensor(xt, mesh, [place(p) for p in src])
        b = D.reshard(a, mesh, [place(p) for p in dst])
        attr = D.dist_attr(b)
        out["pairs"].append({
            "src_global": a.full_tensor().numpy().copy(),
            "global": b.full_tensor().numpy().copy(),
            "local": b.to_local().numpy().copy(),
            "mesh": (attr[0].shape, attr[0].dim_names),
            "placements": [repr(p) for p in attr[1]]})
    lin = nn.Linear(x.shape[1], 3, device="cpu")
    lin.load_state_dict({k: torch.from_numpy(v)
                         for k, v in layer_state.items()})
    mesh = D.ProcessMesh(shape=[2], dim_names=["x"])
    D.shard_layer(lin, mesh)
    out["layer_out"] = lin(D.shard_tensor(xt, mesh, [D.Replicate()])) \
        .full_tensor().detach().numpy().copy()
    out["layer_attrs"] = {n: [repr(q) for q in D.dist_attr(p)[1]]
                          for n, p in lin.named_parameters()}
    return out


def sharding_api_card_session(x, pairs, log_dir):
    """:func:`sharding_api_session`'s ``shard_tensor`` / ``reshard`` pairs
    with CUDA tensors on ranks that share ``cuda:0`` over gloo: each pair's
    global value before and after (read back by a ``reshard`` to
    ``Replicate``), its placements and the device of this rank's block.
    Each rank notes its progress in ``log_dir/sharding_api_card_rank<r>``
    (a fault that kills the process shows where it struck)."""
    import os

    import paddlepaddle_tpu_torch.distributed as D

    rank = _init("gloo")
    torch.cuda.set_device(0)
    log = open(os.path.join(log_dir, f"sharding_api_card_rank{rank}"), "w")

    def note(what):
        log.write(what + "\n")
        log.flush()

    def place(p):
        return {"S": lambda d: D.Shard(d), "R": lambda: D.Replicate(),
                "P": lambda op: D.Partial(op)}[p[0]](*p[1:])

    def whole(t, mesh):
        return D.reshard(t, mesh, [D.Replicate()] * mesh.ndim).to_local()

    xt = torch.from_numpy(x).cuda()
    out = []
    for shape, names, src, dst in pairs:
        mesh = D.ProcessMesh(shape=shape, dim_names=names)
        note(f"shard_tensor {src}")
        a = D.shard_tensor(xt, mesh, [place(p) for p in src])
        note(f"reshard {src} -> {dst}")
        b = D.reshard(a, mesh, [place(p) for p in dst])
        note("read back")
        out.append({"src_global": whole(a, mesh).cpu().numpy(),
                    "global": whole(b, mesh).cpu().numpy(),
                    "placements": [repr(p) for p in D.dist_attr(b)[1]],
                    "device": str(b.to_local().device)})
    note("done")
    return {"rank": rank, "pairs": out}


# -- the pipeline executor and the 4D hybrid (parallel/pipeline_spmd.py,
# parallel/hybrid.py) ------------------------------------------------------


def toy_block(p, a):
    """The reference test's stage block (tests/test_pipeline_schedules.py)."""
    return torch.tanh(a @ p["w"] + p["b"])


def toy_head_loss(hp, a, y):
    return ((a @ hp["wo"] - y) ** 2).mean()


def toy_forward_block(p, a):
    """The reference test's forward-only block (tests/test_pipeline.py)."""
    return torch.tanh(a @ p["w"])


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def pipeline_toy_session(train_arms, forward_arms):
    """Every rank runs each arm: ``train_arms`` are ``(key, stacked, head,
    x, y, schedule, V, mesh shape, mesh names, data_axis)`` through
    ``spmd_pipeline_train`` with the toy block; ``forward_arms`` are
    ``(key, stacked, x, M, shape, names, data_axis, interleaved)``
    through ``spmd_pipeline`` / ``spmd_pipeline_interleaved``. Returns
    ``{key: numpy outputs}``."""
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    _init()
    torch.set_num_threads(1)
    out = {}
    for key, st, hp, x, y, sched, V, shape, names, dax in train_arms:
        got = ps.spmd_pipeline_train(
            _tensors(st), _tensors(hp), _tensors(x), _tensors(y), toy_block,
            toy_head_loss, ProcessMesh(shape=shape, dim_names=names),
            schedule=sched, n_microbatches=8, num_virtual=V,
            data_axis=dax)
        out[key] = _numpy(got)
    for key, st, x, M, shape, names, dax, inter in forward_arms:
        fn = ps.spmd_pipeline_interleaved if inter else ps.spmd_pipeline
        out[key] = fn(_tensors(st), _tensors(x), toy_forward_block,
                      ProcessMesh(shape=shape, dim_names=names), M,
                      data_axis=dax).numpy()
    return out


def hybrid_blocks(cfg, moe):
    """The executor's block and head for a hybrid case: the dense Llama
    stage, the MoE stage (``moe``: ``{"E", "topk", "cf", "ep_size"}``), or
    the dense stage and head over a context-parallel axis (``moe``:
    ``{"sp": size}``)."""
    from paddlepaddle_tpu_torch.parallel import hybrid as H

    cfg = H.HybridStageConfig(**cfg)
    sp = (moe or {}).get("sp")
    if moe and not sp:
        block = H.make_moe_block(cfg, moe["E"], topk=moe["topk"],
                                 capacity_factor=moe["cf"],
                                 ep_size=moe["ep_size"], remat=True)
        specs = H.moe_stage_specs()
    else:
        block = H.make_llama_block(cfg, sp_axis="sp" if sp else None,
                                   sp_size=sp or 1, remat=True)
        specs = H.llama_stage_specs()
    return block, H.make_vocab_parallel_head(
        cfg, sp_axis="sp" if sp else None), specs, H.llama_head_specs()


def hybrid_session(path):
    """Every rank runs each case ``(key, cfg, stacked, head, acts, ids,
    schedule, V, shape, names, moe)`` of the pickle at ``path`` through
    ``spmd_pipeline_train`` over ``("dp", "fsdp")`` data axes with the
    hybrid's block and head, and returns ``{key: (loss, stage grads, head
    grads, dacts)}``."""
    import pickle

    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    with open(path, "rb") as f:
        cases = pickle.load(f)
    _init()
    torch.set_num_threads(1)
    out = {}
    for key, cfg, st, hp, acts, ids, sched, V, shape, names, moe in cases:
        block, head, specs, hspecs = hybrid_blocks(cfg, moe)
        got = ps.spmd_pipeline_train(
            _tensors(st), _tensors(hp), _tensors(acts),
            _tensors(ids).long(), block, head,
            ProcessMesh(shape=shape, dim_names=names), schedule=sched,
            n_microbatches=4, num_virtual=V, data_axis=("dp", "fsdp"),
            param_specs=specs, head_specs=hspecs,
            seq_axis="sp" if (moe or {}).get("sp") else None)
        out[key] = (float(got[0]),) + tuple(_numpy(g) for g in got[1:])
    return out


PP_CARD_CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                   num_kv_heads=2, layers_per_stage=1, vocab_size=512,
                   max_seq_len=128)


def pp_card_problem(seed, n_stages, device, batch=(4, 128)):
    """Seeded f32 stage and head params (the reference's init scales), an
    embedded batch and its ids for :data:`PP_CARD_CFG`, on ``device``."""
    from paddlepaddle_tpu_torch.parallel import hybrid as H

    cfg = H.HybridStageConfig(**PP_CARD_CFG)
    g = torch.Generator(device=device).manual_seed(seed)
    stages = [H.init_llama_stage(cfg, g) for _ in range(n_stages)]
    head = H.init_llama_head(cfg, g)
    acts = torch.randn(batch + (cfg.hidden_size,), generator=g,
                       device=device)
    ids = torch.randint(0, cfg.vocab_size, batch, generator=g, device=device)
    return cfg, stages, head, acts, ids


def pp_card_oracle(cfg, stages, head, acts, ids):
    """``reference_forward`` (plain attention) and its gradients, stacked
    as the executor returns them."""
    from paddlepaddle_tpu_torch.parallel import hybrid as H
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    st = [{k: v.clone().requires_grad_() for k, v in s.items()}
          for s in stages]
    hp = {k: v.clone().requires_grad_() for k, v in head.items()}
    a = acts.clone().requires_grad_()
    loss = H.reference_forward(cfg, st, hp, a, ids)
    loss.backward()
    return (float(loss.detach()),
            ps.stack_stage_params([{k: v.grad for k, v in s.items()}
                                   for s in st]),
            {k: v.grad for k, v in hp.items()}, a.grad)


def pp_card_errors(got, want) -> dict:
    """Loss relative error and the largest gradient error beyond
    ``2e-4 + 2e-3 |want|`` (tests/test_hybrid_4d.py's tolerances)."""
    loss, g_st, g_h, g_a = got
    r_loss, r_st, r_h, r_a = want

    def over(x, y):
        return float(((x - y).abs() - (2e-4 + 2e-3 * y.abs())).max())

    worst = max([over(g_st[k], r_st[k]) for k in r_st]
                + [over(g_h[k], r_h[k]) for k in r_h] + [over(g_a, r_a)])
    return {"loss_rel": abs(float(loss) - r_loss) / abs(r_loss),
            "worst_over_tol": worst}


def pipeline_card_session(schedule):
    """tp2 pp2 on four ranks sharing ``cuda:0`` over gloo: the hybrid's
    Llama stages through ``spmd_pipeline_train`` under ``schedule``, its
    errors against the oracle on the card and this rank's kernel 2-4
    launches."""
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.parallel import hybrid as H
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    rank = _init()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, stages, head, acts, ids = pp_card_problem(0, 2, dev)
    mesh = ProcessMesh(shape=[2, 2], dim_names=["tp", "pp"])
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0
    got = ps.spmd_pipeline_train(
        ps.stack_stage_params(stages), head, acts, ids,
        H.make_llama_block(cfg, fsdp_axis=None),
        H.make_vocab_parallel_head(cfg), mesh, schedule=schedule,
        n_microbatches=4, param_specs=H.llama_stage_specs(fsdp_axis=None),
        head_specs=H.llama_head_specs())
    launches = {w.__name__: w.launches
                for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}
    errs = pp_card_errors(got, pp_card_oracle(cfg, stages, head, acts, ids))
    return {"rank": rank, "pp": mesh.coords(rank)["pp"],
            "launches": launches, **errs}


# -- context parallelism: ring attention and the context-parallel step ---------

CP_CFG = dict(FSDP_CFG, context_parallel_axis="sp")


def ring_blocks(q, k, v, cot, causal, route):
    """This rank's ring attention over its blocks of ``q``/``k``/``v``
    (whole numpy arrays, sequence dim 1, the ``sp`` axis the job's world)
    by ``route`` (``"plain"`` or ``"flash"``: the kernel path's function on
    CPU tensors, whose blocks are the flash wrappers' plain versions):
    the output block and this rank's blocks of the q, k, v gradients of
    ``sum(out * cot)``."""
    from paddlepaddle_tpu_torch.distributed import ProcessMesh, get_rank
    from paddlepaddle_tpu_torch.distributed import get_world_size
    from paddlepaddle_tpu_torch.ops.kernels import ring_attention as RA

    n, r = get_world_size(), get_rank()
    mesh = ProcessMesh(shape=[1, n], dim_names=["dp", "sp"])
    ts = [torch.from_numpy(a).chunk(n, dim=1)[r].contiguous()
          .requires_grad_(True) for a in (q, k, v)]
    ring = RA.ring_of(mesh, "sp")
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if route == "plain":
        out = RA.ring_attention(*ts, mesh, causal=causal)
    else:
        out = RA._RingFlash.apply(*ts, ring, causal, scale)
    c = torch.from_numpy(cot).chunk(n, dim=1)[r]
    (out * c).sum().backward()
    return (out.detach().numpy(),) + tuple(t.grad.numpy() for t in ts)


def cp_llama(state, cfg=None):
    """The port's tiny context-parallel Llama on the CPU holding ``state``
    (the JAX model's, as numpy)."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.convert import load_jax_state

    model = pt.LlamaForCausalLM(pt.LlamaConfig(**(cfg or CP_CFG)),
                                device="cpu")
    load_jax_state(model, state)
    return model


def cp_step(state, shape, names, cfg=None, lr=1e-3):
    """The port's ``ShardedTrainStep(seq_axis="sp")`` over the tiny
    Llama (AdamW at ``lr``), data axes ``("dp",)``."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    model = cp_llama(state, cfg)
    return ShardedTrainStep(
        model, pt.AdamW(learning_rate=lr, parameters=model.parameters()),
        lambda m, i, l: m(i, labels=l),
        mesh=ProcessMesh(shape=shape, dim_names=names),
        rules=llama_sharding_rules(), data_axes=("dp",), seq_axis="sp")


def cp_train(step, ids, labels, n_steps):
    """``n_steps`` losses and every parameter whole after them."""
    ids_t = torch.from_numpy(ids).long()
    lab_t = torch.from_numpy(labels).long()
    losses = [float(step(ids_t, lab_t)) for _ in range(n_steps)]
    return {"losses": losses,
            "params": {n: t.numpy().copy()
                       for n, t in step.full_params().items()}}


def context_parallel_session(ring_cases, state, ids, labels, n_steps):
    """Four gloo ranks: each ring case ``(key, q, k, v, cot, causal,
    route)`` over ``sp4`` (with the ring's point-to-point messages
    counted), then the SPMD form of the context-parallel step over
    ``dp2 sp2``."""
    from paddlepaddle_tpu_torch.distributed.collective import (
        collective_stats, reset_collective_stats)

    rank = _init()
    torch.set_num_threads(1)
    out = {"rank": rank}
    for key, q, k, v, cot, causal, route in ring_cases:
        reset_collective_stats()
        out[key] = ring_blocks(q, k, v, cot, causal, route)
        out[key + " p2p"] = collective_stats().get("p2p_send", {})
    step = cp_step(state, [2, 2], ["dp", "sp"])
    run = cp_train(step, ids, labels, n_steps)
    if rank:
        run.pop("params")
    out["dp2sp2"] = run
    return out


# -- Megatron sequence parallelism (mpu) ----------------------------------------


class TapMomentum(_PortMomentum):
    """The port's ``Momentum``, recording the gradients its first
    ``apply`` receives (after the step's sums, before the update) in
    ``first``, by name, as numpy."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.first = {}

    def apply(self, grads=None, lr=None):
        if not self.first:
            self.first = {n: g.detach().float().cpu().numpy().copy()
                          for n, g in zip(self._names, grads)}
        return super().apply(grads, lr)


class SPBlock(torch.nn.Module):
    """The port's sequence-parallel block over the five ``mpu`` names, in
    one process (whole weights): ``x`` scattered into sequence blocks, a
    norm (a sequence-parallel parameter), ``ColumnSequenceParallelLinear``,
    silu, ``RowSequenceParallelLinear``, the residual, the blocks
    gathered."""

    def __init__(self, h, f):
        from paddlepaddle_tpu_torch.nn.norm import RMSNorm
        from paddlepaddle_tpu_torch.parallel import mpu

        super().__init__()
        self.norm = RMSNorm(h, device="cpu")
        mpu.mark_as_sequence_parallel_parameter(self.norm.weight)
        self.col = mpu.ColumnSequenceParallelLinear(
            h, f, has_bias=True, gather_output=False, device="cpu")
        self.row = mpu.RowSequenceParallelLinear(
            f, h, has_bias=True, input_is_parallel=True, device="cpu")

    def forward(self, x):
        from paddlepaddle_tpu_torch.parallel import mpu

        x = mpu.scatter_to_sequence_parallel(x)
        y = self.row(torch.nn.functional.silu(self.col(self.norm(x))))
        return mpu.gather_from_sequence_parallel(x + y)


def sp_mlp_net(state, h, f):
    """An :class:`SPBlock` holding ``state`` (the JAX block's weights by
    the same names)."""
    net = SPBlock(h, f)
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(state[n]))
    return net


# -- A10 slice 6: the distributed checkpoint and the collective fleet -------

# vocab 65: the embedding's fsdp dim does not split over 2 ranks, so the
# plan leaves it whole (an uneven fsdp cut: one box, the unpadded range)
CKPT_CFG = dict(FSDP_CFG, vocab_size=65)


def ckpt_step(state, shape, names, rules_axis, lr=1e-3, clip=0.5):
    """A ``ShardedTrainStep`` over a ``CKPT_CFG`` Llama holding ``state``
    (AdamW + global-norm clip) on the mesh ``shape`` / ``names``."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.models.llama import llama_sharding_rules
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    model = port_llama(state, "float32", CKPT_CFG)
    opt = pt.AdamW(learning_rate=lr, parameters=model.named_parameters(),
                   grad_clip=pt.ClipGradByGlobalNorm(clip))
    return ShardedTrainStep(
        model, opt, lambda m, i, l: m(i, labels=l),
        mesh=ProcessMesh(shape=shape, dim_names=names),
        rules=llama_sharding_rules(tp_axis=rules_axis))


def ckpt_fsdp_session(state, ids, labels, path):
    """The SPMD ``fsdp2`` step: two steps, an async save of the whole step
    to ``path`` (each rank its blocks, rank 0 merging), then a third step
    beside the write; the checkpoint loaded back into the step gives every
    rank the bits it held at the save (digests). Also ``step.params`` and
    ``step.opt_state`` saved apart (the reference's user code). Losses,
    the digests' agreement, the two saves' keys and this rank's local
    shapes."""
    from paddlepaddle_tpu_torch.distributed import checkpoint as dckpt

    _init()
    step = ckpt_step(state, [2], ["fsdp"], "tp")
    ids_t, lab_t = torch.from_numpy(ids), torch.from_numpy(labels)
    losses = [float(step(ids_t, lab_t)) for _ in range(2)]
    digests = step._rank_digests()
    dckpt.save_state_dict(step.state_dict(), path, async_save=True)
    dckpt.save_state_dict(step.params, path + ".params")
    dckpt.save_state_dict(step.opt_state, path + ".opt")
    losses.append(float(step(ids_t, lab_t)))
    dckpt.wait_all_saves()
    moved = step._rank_digests() != digests
    dckpt.load_state_dict(step.state_dict(), path)
    return {"losses": losses, "moved": moved,
            "restored": step._rank_digests() == digests,
            "keys": {k: sorted(dckpt.get_checkpoint_metadata(
                path + k)["tensors"]) for k in ("", ".params", ".opt")},
            "shapes": {n: tuple(p.shape) for n, p in step.params.items()}}


def fake_dtensor_load(path, mesh_shape, names, specs, shapes, out_path):
    """Each rank of ``mesh_shape`` in turn, under a fake process group of
    that world: ``DTensor`` targets of zeros placed by ``specs`` (``{key:
    [("S", d) | ("R",), ...]}``) loaded from ``path``; the local blocks of
    every rank, pickled to ``out_path``."""
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from paddlepaddle_tpu_torch.distributed import checkpoint as dckpt

    world = int(np.prod(mesh_shape))
    out = {}
    for r in range(world):
        dist.init_process_group("fake", rank=r, world_size=world,
                                store=FakeStore())
        try:
            mesh = DeviceMesh("cpu", np.arange(world).reshape(
                mesh_shape).tolist(), mesh_dim_names=tuple(names))
            sd = {}
            for key, spec in specs.items():
                pl = [Shard(p[1]) if p[0] == "S" else Replicate()
                      for p in spec]
                full = torch.zeros(shapes[key])
                local = full
                coord = mesh.get_coordinate()
                for axis, p in enumerate(pl):
                    if isinstance(p, Shard):
                        local = local.chunk(mesh_shape[axis],
                                            dim=p.dim)[coord[axis]]
                sd[key] = DTensor.from_local(
                    local.contiguous().clone(), mesh, pl, run_check=False,
                    shape=full.shape, stride=full.stride())
            dckpt.load_state_dict(sd, path)
            out[r] = {"coord": list(mesh.get_coordinate()),
                      "local": {k: v.to_local().numpy().copy()
                                for k, v in sd.items()}}
        finally:
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def fleet_topology_session(configs):
    """``fleet.init`` on this job's ranks for each hybrid config: this
    rank's coordinate from every accessor and the ranks of each of its
    groups."""
    from paddlepaddle_tpu_torch.distributed import fleet

    rank = _init()
    out = []
    for hc in configs:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = dict(hc)
        fleet.init(is_collective=True, strategy=strategy)
        h = fleet.get_hybrid_communicate_group()
        out.append({
            "rank": rank, "global_rank": h.global_rank,
            "worker_index": fleet.worker_index(),
            "first": fleet.is_first_worker(),
            "coord": {"data": h.get_data_parallel_rank(),
                      "pipe": h.get_stage_id(),
                      "sharding": h.get_sharding_parallel_rank(),
                      "sep": h.get_sep_parallel_rank(),
                      "model": h.get_model_parallel_rank()},
            "groups": {"data": h.get_data_parallel_group().ranks,
                       "pipe": h.get_pipe_parallel_group().ranks,
                       "sharding": h.get_sharding_parallel_group().ranks,
                       "sep": h.get_sep_parallel_group().ranks,
                       "model": h.get_model_parallel_group().ranks},
            "src": {"data": h.get_data_parallel_group_src_rank(),
                    "model": h.get_model_parallel_group_src_rank()},
            "stage1_rank": h.get_rank_from_stage(
                min(1, h.get_pipe_parallel_world_size() - 1))})
        out[-1]["dp_model"] = type(fleet.distributed_model(
            torch.nn.Linear(2, 2))).__name__
        # the model group is a working process group
        t = torch.tensor([float(rank)])
        from paddlepaddle_tpu_torch.distributed import all_reduce

        all_reduce(t, group=h.get_model_parallel_group())
        out[-1]["mp_sum"] = float(t)
        fleet.barrier_worker()
    return out


def fleet_mp2_session(weights, x, y, clip, n_steps, grads):
    """On ``mp2`` (``fleet.init``): the MLP ``relu(x W1 + b1) W2 + b2``
    as a column- then a row-parallel layer holding this rank's blocks of
    ``weights``; ``fleet.distributed_optimizer`` over AdamW, then over SGD
    (a step that moves with the clip's scale), each with
    ``ClipGradByGlobalNorm(clip)``: their losses and the whole weights
    after ``n_steps``. Then ``GradScaler``'s skip-or-step with an inf in
    rank 1's gradient alone (``grads``), and a ``LocalSGD`` average."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import all_gather, fleet
    from paddlepaddle_tpu_torch.distributed.fleet import meta_parallel as mpp

    rank = _init()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = {"rank": rank}
    for name in ("adamw", "sgd"):
        col = mpp.ColumnParallelLinear(x.shape[1], weights["w1"].shape[1],
                                       has_bias=True, gather_output=False,
                                       device="cpu")
        row = mpp.RowParallelLinear(weights["w1"].shape[1], y.shape[1],
                                    has_bias=True, input_is_parallel=True,
                                    device="cpu")
        r, n = hcg.get_model_parallel_rank(), 2
        with torch.no_grad():
            col.weight.copy_(torch.from_numpy(weights["w1"]).chunk(n, 1)[r])
            col.bias.copy_(torch.from_numpy(weights["b1"]).chunk(n, 0)[r])
            row.weight.copy_(torch.from_numpy(weights["w2"]).chunk(n, 0)[r])
            row.bias.copy_(torch.from_numpy(weights["b2"]))
        net = fleet.distributed_model(torch.nn.Sequential(
            col, torch.nn.ReLU(), row))
        params = list(net.named_parameters())
        inner = (pt.AdamW(learning_rate=1e-2, parameters=params,
                          grad_clip=pt.ClipGradByGlobalNorm(clip))
                 if name == "adamw" else
                 pt.SGD(learning_rate=0.1, parameters=params,
                        grad_clip=pt.ClipGradByGlobalNorm(clip)))
        opt = fleet.distributed_optimizer(inner)
        losses = []
        for _ in range(n_steps):
            loss = ((net(xt) - yt) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        whole = {}
        for key, p, dim in (("w1", col.weight, 1), ("b1", col.bias, 0),
                            ("w2", row.weight, 0)):
            parts = []
            all_gather(parts, p.detach().contiguous(),
                       group=hcg.get_model_parallel_group())
            whole[key] = torch.cat(parts, dim).numpy().copy()
        whole["b2"] = row.bias.detach().numpy().copy()
        out[name] = {"losses": losses, "weights": whole,
                     "wrapped": type(opt).__name__}
    # GradScaler: only rank 1 sees an inf; both ranks must skip together
    lin = torch.nn.Linear(grads.shape[1], 1, bias=False)
    sgd = pt.SGD(learning_rate=0.5, parameters=list(lin.named_parameters()))
    scaler = pt.amp.GradScaler(init_loss_scaling=4.0)
    before = lin.weight.detach().clone()
    g = torch.from_numpy(grads[rank:rank + 1]).float()
    lin.weight.grad = g * 4.0
    scaler.step(sgd)
    out["scaler"] = {"found_inf": bool(scaler._found_inf),
                     "stepped": not torch.equal(before, lin.weight.detach()),
                     "scale": float(scaler._scale)}
    # LocalSGD: lr 0 local steps, then the average of rank 1.0 and 2.0
    w = torch.nn.Linear(2, 1)
    with torch.no_grad():
        w.weight.fill_(float(rank + 1))
        w.bias.zero_()
    lsgd = fleet.LocalSGD(pt.SGD(learning_rate=0.0,
                                 parameters=list(w.named_parameters())),
                          k_steps=2)
    seen = []
    for _ in range(2):
        w(torch.ones(1, 2)).mean().backward()
        lsgd.step()
        lsgd.clear_grad()
        seen.append(w.weight.detach().numpy().copy())
    out["localsgd"] = seen
    return out


# ---------------------------------------------------------------------------
# distributed.compat (tests/test_torch_compat.py)
# ---------------------------------------------------------------------------

def compat_session(device="cpu"):
    """Every compat collective over 2 gloo ranks on ``device`` tensors;
    returns this rank's results as numpy / plain values."""
    from paddlepaddle_tpu_torch.distributed import compat as C

    rank = _init()
    dev = torch.device(device)
    out = {"rank": rank, "backend": C.get_backend(),
           "available": C.is_available()}
    # uneven splits: rank r sends r + 1 + j rows of width 3 to rank j
    splits = [rank + 1, rank + 2]
    rows = sum(splits)
    x = (torch.arange(rows * 3, dtype=torch.float32, device=dev)
         .reshape(rows, 3) + 100 * rank)
    y = torch.empty(0, 3, device=dev)
    C.alltoall_single(y, x, in_split_sizes=splits)
    out["alltoall_single"] = y.cpu().numpy()
    even = torch.arange(4, dtype=torch.int64, device=dev) + 10 * rank
    z = torch.empty(4, dtype=torch.int64, device=dev)
    C.alltoall_single(z, even)
    out["alltoall_single_even"] = z.cpu().numpy()
    got = []
    C.alltoall(got, [torch.full((2,), 10.0 * rank + j, device=dev)
                     for j in range(2)])
    out["alltoall"] = [t.cpu().numpy() for t in got]
    gl = []
    C.gather(torch.tensor([rank * 1.5], device=dev), gl, dst=0)
    out["gather"] = [t.cpu().numpy() for t in gl]
    objs = [{"from": rank, "tags": ["a", rank]}, (rank, 2.5)]
    C.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    recv = []
    C.scatter_object_list(recv, [{"to": r, "payload": list(range(r + 2))}
                                 for r in range(2)] if rank == 0 else None,
                          src=0)
    out["scatter_object_list"] = recv
    env = C.ParallelEnv()
    out["env"] = [env.rank, env.world_size, env.nranks, env.local_rank,
                  env.device_id]
    out["wait_is_identity"] = C.wait(x) is x
    C.destroy_process_group()
    import torch.distributed as dist

    out["destroyed"] = not dist.is_initialized()
    return out
