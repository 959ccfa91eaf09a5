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
