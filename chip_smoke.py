#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddlepaddle_tpu_torch``) on one NVIDIA
Hopper card and check it. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check raises and the exit
code is non-zero):

1. ``env``     card name and power limit (nvidia-smi), torch / CUDA
               versions. TF32 is switched off for matmuls and cuDNN, so
               every f32 comparison below is full f32.
2. ``build``   builds every kernel in ``ops/kernels/csrc`` (one nvcc per
               source, in parallel) and reports time and ptxas' resource use.
3. ``kernel``  paged attention (the context-split kernel and its merge)
               against its plain PyTorch version on the card: small shapes
               (W=1 and W=3, f32 atol 1e-5, bf16 atol 2e-2, ragged lens with
               0 and a zeroed table row), split cases (P 32 pages of 16, W 1,
               2 and 4, lens on and across the split boundaries of the
               plan, with n_split printed) and the main-path shape (h=32,
               kvh=8, hd=128, ps=64, 8 slots, lens 64-2000);
               CUDA-event timings (median, L2 flushed between launches) of
               the kernel, the plain version and SDPA on the pre-gathered
               view, beside the memory/compute bound.
3q. ``kernel_int8``  the int8 variant of paged attention (kernel 1q: int8
               pools, per-page, per-head f32 scales) against its plain
               version: small shapes (W 1 and 3, q f32 atol 1e-5 and bf16
               atol 2e-2, hd 64 and 128, lens with 0, a zeroed table row, a
               zero-scale page; the split cases of phase 3) and, at q f32,
               against kernel 1 run over the pools dequantized beforehand
               (expected bit-equal; the max difference is printed); the
               shared-memory mirror; the main-path shape (h 32, kvh 8,
               hd 128, ps 64, 8 slots, lens 64-2000, bf16 q) timed beside
               kernel 1 at the same lens over bf16 pools, the plain version
               and the dequantize-then-SDPA composition, with the bound.
4. ``flash_kernel``  the flash-attention forward, dQ and dK/dV kernels
               (bf16: the TMA/wgmma kernels; f32: the FMA kernels) against
               the plain forward and its autograd backward: 40 small cases
               (d 64/128, f32 atol 1e-5 / bf16 atol 2e-2, causal and full,
               s_q == s_k, s_q < s_k, ragged s 100; bf16 also s_q 1 against
               s_k 2048, s 130, (200, 333) and s 257), the plain routes
               (d 96, causal s_q > s_k: no kernel, within 1e-5 of the CPU)
               and the train phase's shape (b 4, s 2048, h 32, d 128, bf16,
               causal), where two launches of the backward pair must give
               the same bits; timings of each kernel, the plain version and
               SDPA (forward; its backward for the two backward kernels),
               beside the bound.
4v. ``flash_varlen_kernel``  the packed varlen forward, dQ and dK/dV kernels
               (5-7; bf16: the TMA/wgmma kernels; f32: the FMA kernels) against
               their plain versions on the same inputs: 72 small cases (9
               layouts: a padding tail with empty segments first, in the middle
               and last; cu_q != cu_k; causal rows with no key and a segment
               with no keys; 64 one-token segments; a tile over five segments;
               t not a multiple of 8; a 128-row tile over three segments and a
               segment longer than 3 stages of 128 keys; len_k > len_q over
               several key tiles with t_q % 4 != 0; a 64-row consumer over
               three segments whose keys start inside a 64-key tile; d 64/128,
               f32 atol 1e-5 / bf16 atol 2e-2 + rtol 1e-2, causal and full)
               with rows without a key and keys without a row exactly 0; one
               segment over the buffer against the dense kernels (max
               difference printed, dQ's apart; bf16 within 2e-2); each kernel's
               ptxas registers and spills; then the main path at Llama-3-8B
               attention width (h 32, d 128, bf16) through the public entries,
               counters from 0: (a) ``flash_attn_unpadded`` forward and
               backward on a packed batch (8192 tokens in segments of 64-2048,
               one empty, a 64-row tail, causal; each counter exactly 1), (b)
               chunked prefill (8 chunks of 256 against contexts of 512-4096,
               causal), (c) ``variable_length_memory_efficient_attention`` at
               [8, 32, 2048, 128] with lengths 64-2048 (full); (a) and (b)
               against the plain versions in head chunks (atol 2e-2 + rtol
               1e-2), (a) again in f32 (atol 1e-5), (c) per sequence; two
               launches of dQ and two of dK/dV at (a) give the same bits;
               timings at (a) of each kernel, the plain versions and one
               PyTorch call (SDPA over nested jagged tensors if this torch
               takes them causal, else with the block-diagonal mask), beside
               the bound over the visible pairs.
5. ``gather_gemm_kernel``  the gather-GEMM expert FFN's two kernels
               (bf16: gather_gateup_sm90 and expert_down_sm90, TMA +
               wgmma; f32: the FMA pair) each against its plain half, and
               the call against its plain version: 6 small cases (f32 atol
               1e-5; bf16 one bf16 step a phase plus the slack of f32
               summation orders, sqrt(K) 2^-24 (|a| @ |b|), and, for the
               call, the bound its bf16 rounding of hmid implies;
               planted drops, an empty expert, all-sentinel 64-slot halves,
               C not a multiple of the row tile, T 1, the smallest (d, h)
               the support check admits); the shared-memory plan, Python
               against CUDA; then two full-width bf16 cases, slots from a
               routing of random x: the moe_train shape (E 64, C 320,
               T 8192, d 2048, h 1408) and Mixtral-8x7B's expert widths
               (E 8, C 640, T 2048, d 4096, h 14336); for each, timings of
               each phase, the call, the plain version and the sorted
               mode's composition (gather, two bmm, silu*mul, bmm), beside
               the bounds of each phase and of the call.
6. ``engine_parity``  a tiny fp32 Llama served greedily by the port engine
               on the card (kernel) and on the CPU (plain version): equal
               tokens.
6q. ``engine_parity_int8``  a tiny fp32 Llama with ``kv_quant="int8"``,
               prefix requests and a pool of 5 pages, so prefixes spill to
               the host tier and come back: card and CPU give equal tokens
               and equal prefix / host counters, and the int8 kernel ran
               layers x decode steps times.
7. ``train_parity``  a tiny fp32 Llama (d 64) trained 3 TrainStep steps on
               the card and on the CPU from one state and one batch: losses
               within 1e-4, parameters within 5e-4 (half a step's move),
               flash launch counters moved.
8. ``moe_parity``  a tiny fp32 MoE decoder (fused mode, d 256, h 128, 4
               experts) trained 3 TrainStep steps on the card and on the CPU
               from one state: losses within 1e-4, parameters within 5e-4,
               the gather-GEMM counter moved by layers x steps.
9. ``serve``   the serving path at full width: Llama-3-8B (bf16, seeded
               random weights) behind ``ServingEngine(max_batch_size=8,
               kv_page_size=64, max_len=2048, decode_chunk=16)`` answering
               24 requests (prompts 64-1536, budgets 32-128, two sampled);
               every future must complete with its full length and in-vocab
               tokens, and the paged-attention launch count must equal
               32 layers x decode steps.
9q. ``serve_int8``  Llama-3-8B (bf16, seeded weights) behind
               ``ServingEngine(max_batch_size=8, kv_page_size=64,
               max_len=2048, decode_chunk=16, kv_quant="int8",
               kv_host_bytes=256 MiB)`` with a page pool that holds the 8
               slots' private pages and two of four shared prefixes: 32
               requests round-robin over four 1024-token system prompts,
               each with a 64-512-token tail, ``prefix_len=1024``, budgets
               32-128, two sampled. Every future completes at full length
               with in-vocab tokens, prefixes spill and restore, and the
               int8 kernel ran 32 layers x decode steps times; tok/s, TTFT,
               TPOT, prefix and host counters, restore ms, KV bytes against
               a bf16 pool of the same page count, and the decode device
               time by kind with the idle share.
10. ``train`` the training path at full width: Llama-3-8B widths cut to 8
               of 32 layers (memory), bf16 with f32 AdamW masters and a
               global-norm clip, batch 4 x 2048 fed 7 times (1 warm-up, 5
               timed, 1 profiled); losses finite and falling, each flash
               counter exactly layers x steps, no non-finite parameter;
               step time, tokens/s, MFU, peak memory and the device time by
               kind.
11. ``moe_train``  the MoE decoder at DeepSeekMoE-16B widths (hidden 2048,
               64 experts of width 1408, 2 shared, vocab 102400, top-2,
               capacity factor 1.25, fused mode) cut to 4 of 28 layers
               (memory), bf16 with f32 AdamW masters and a global-norm clip,
               batch 4 x 2048 fed 7 times (1 warm-up, 5 timed, 1 profiled);
               losses finite and falling, the gather-GEMM counters (calls
               and each of its two kernels) and flash counters exactly
               layers x steps, no non-finite parameter; step time,
               tokens/s, MFU on the active parameters, peak memory, device
               time by kind and the share of routed entries each layer's
               capacity dropped.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
PAGED_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/paged_attention.cu"
PAGED_REPLACES = "paddlepaddle_tpu/ops/kernels/paged_attention.py:104"
FLASH_FWD_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_fwd_sm90.cu"
FLASH_BWD_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_bwd_sm90.cu"
GATHER_GEMM_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/gather_gemm_sm90.cu"
GATHER_GEMM_REPLACES = "paddlepaddle_tpu/ops/kernels/gather_gemm.py:80"
VARLEN_SOURCES = {
    "varlen_fwd": "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu",
    "varlen_bwd_dq":
        "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu",
    "varlen_bwd_dkv":
        "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu"}
VARLEN_REPLACES = {
    "varlen_fwd": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:123",
    "varlen_bwd_dq": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:156",
    "varlen_bwd_dkv": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:184"}
FLASH_REPLACES = {"flash_fwd": "paddlepaddle_tpu/ops/kernels/flash_attention.py:97",
                  "flash_bwd_dq": "paddlepaddle_tpu/ops/kernels/flash_attention.py:139",
                  "flash_bwd_dkv": "paddlepaddle_tpu/ops/kernels/flash_attention.py:172"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A mangled kernel name as its last name component, head dim and
    element type, as ``varlen_bwd_dq_kernel_d64_f32``."""
    import re

    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name, i = mangled, 0
    while i < len(s) and s[i].isdigit():     # <length><identifier> ...
        j = i
        while s[j].isdigit():
            j += 1
        name, i = s[j:j + int(s[i:j])], j + int(s[i:j])
    args = s[i:] if s[i:i + 1] == "I" else ""
    dim = re.search(r"Li(\d+)E", args)
    kind = ("bf16" if args.startswith("I13__nv_bfloat16")
            else "f32" if args.startswith("If") else "")
    return "_".join(x for x in (name, f"d{dim.group(1)}" if dim else "",
                                kind) if x)


def ptxas_kernels(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, keyed by :func:`kernel_name`."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def median_ms(fn, reps: int = 30, warmup: int = 3, flush=None) -> float:
    """Median per-call DEVICE time from CUDA events. The GPU is first given
    ~20 ms of queued work so that the host enqueues every timed call ahead
    of the device, and the events then bracket device time only (not the
    wrapper's Python). ``flush`` (a buffer larger than L2) is rewritten
    between calls so each call finds L2 cold."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)            # ~20 ms of device spin
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def host_us(fn, reps: int = 200) -> float:
    """Mean host time of one call (enqueue only, no sync), in µs."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)           # keep the device busy meanwhile
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens, dtype, zero_rows=()):
    import numpy as np
    import torch

    pages = 1 + S * P
    kp = torch.from_numpy(rng.standard_normal((pages, ps, kvh, hd),
                                              dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((pages, ps, kvh, hd),
                                              dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((S, W, h, hd), dtype=np.float32))
    pt = rng.permutation(np.arange(1, pages))[: S * P].reshape(S, P)
    pt = pt.astype(np.int32)
    for r in zero_rows:
        pt[r] = 0
    dev = "cuda"
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(pt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def split_lens(pa, S, kvh, ps, P, W):
    """Slot lengths for the split checks: 0, each side of the first split
    boundary, the middle one and the last one, and the end of the table,
    under the plan the kernel takes for (S, kvh, P) on this card."""
    import torch

    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(torch.device("cuda")))
    bounds = [pps * ps * i for i in range(1, n_split)] or [ps]
    lens = [0, bounds[0] - 1, bounds[0], bounds[len(bounds) // 2] + 5,
            bounds[-1] + 1, P * ps - W]
    return lens[:S], n_split, pps


def phase_kernel():
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    small = []
    for hd in (64, 128):
        for W in (1, 3):
            for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                args = paged_inputs(rng, 4, W, 8, 2, hd, 16, 3,
                                    [5, 13, 0, 40], dtype, zero_rows=(2,))
                kw = dict(rep=4, scale=hd ** -0.5)
                got = pa.paged_attention(*args, **kw)
                want = pa.paged_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                small.append({"hd": hd, "W": W, "dtype": str(dtype)[6:],
                              "max_abs_err": err, "atol": atol})
                if not err <= atol:
                    raise AssertionError(f"paged_attention small shape "
                                         f"hd={hd} W={W} {dtype}: err {err} "
                                         f"> {atol}")

    # the context split: P 32 pages of 16 with lens on and across the split
    # boundaries, W 1, 2 and 4, a zeroed table row, under two plans (6 slots
    # x 2 KV heads: splits of one page; 8 x 8: the main shape's splits of 4
    # pages); inputs from their own seed, so the main shape draws the same
    # lens as before the split
    split_rng = np.random.default_rng(10)
    for (S_, h_, kvh_), hd, W in itertools.product(
            ((6, 8, 2), (8, 32, 8)), (64, 128), (1, 2, 4)):
        lens_s, n_split_s, pps_s = split_lens(pa, S_, kvh_, 16, 32, W)
        lens_s = (lens_s * 2)[:S_]
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = paged_inputs(split_rng, S_, W, h_, kvh_, hd, 16, 32,
                                lens_s, dtype, zero_rows=(1,))
            kw = dict(rep=h_ // kvh_, scale=hd ** -0.5)
            got = pa.paged_attention(*args, **kw)
            want = pa.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            small.append({"S": S_, "kvh": kvh_, "hd": hd, "W": W,
                          "dtype": str(dtype)[6:], "P": 32, "lens": lens_s,
                          "n_split": n_split_s, "pages_per_split": pps_s,
                          "max_abs_err": err, "atol": atol})
            if not err <= atol:
                raise AssertionError(f"paged_attention split case S={S_} "
                                     f"hd={hd} W={W} {dtype}: err {err} > "
                                     f"{atol}")

    # main-path shape: Llama-3-8B decode step, 8 slots, max_len 2048
    S, W, h, kvh, hd, ps, P = 8, 1, 32, 8, 128, 64, 32
    lens = rng.integers(64, 2001, S).tolist()
    args = paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens, torch.bfloat16)
    q, kp, vp, ptab, lens_t = args
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(q.device))
    got = pa.paged_attention(*args, **kw)
    want = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"paged_attention main shape: err {err} > 2e-2")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = median_ms(lambda: pa.paged_attention(*args, **kw), flush=flush)
    plain_ms = median_ms(lambda: pa.paged_attention_plain(*args, **kw),
                         flush=flush)
    wrapper_us = host_us(lambda: pa.paged_attention(*args, **kw))
    # yardstick only: SDPA on the pre-gathered view (gather not timed)
    T = P * ps
    kview = kp[ptab.long()].reshape(S, T, kvh, hd).transpose(1, 2).contiguous()
    vview = vp[ptab.long()].reshape(S, T, kvh, hd).transpose(1, 2).contiguous()
    qs = q.transpose(1, 2).contiguous()                       # [S, h, W, hd]
    k_pos = torch.arange(T, device="cuda")
    q_pos = lens_t.long()[:, None] + torch.arange(W, device="cuda")[None, :]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # [S,1,W,T]
    try:
        library_ms = median_ms(lambda: tF.scaled_dot_product_attention(
            qs, kview, vview, attn_mask=mask, scale=kw["scale"],
            enable_gqa=True), flush=flush)
    except (TypeError, RuntimeError):
        kr = kview.repeat_interleave(h // kvh, dim=1)
        vr = vview.repeat_interleave(h // kvh, dim=1)
        library_ms = median_ms(lambda: tF.scaled_dot_product_attention(
            qs, kr, vr, attn_mask=mask, scale=kw["scale"]), flush=flush)
    del flush

    # least time for the same work, from this run's lens (paged_work)
    item = q.element_size()
    bytes_, flops = paged_work(lens, W, h, kvh, hd, ps, P, item, item)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    record = {
        "name": "paged_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": None, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shape": f"S{S} W{W} h{h} kvh{kvh} hd{hd} ps{ps} bf16 "
                 f"lens {min(lens)}-{max(lens)}",
        "bytes": bytes_, "flops": flops,
    }
    emit({"phase": "kernel", "small": small, "main_shape": record["shape"],
          "n_split": n_split, "pages_per_split": pps,
          "lens": lens, "max_abs_err": err, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "wrapper_host_us": wrapper_us, "bound_ms": record["bound_ms"],
          "bound_share": record["bound_ms"] / kernel_ms})
    return record


def paged_work(lens, W, h, kvh, hd, ps, P, q_item, kv_item, scales=False):
    """Bytes and f32 operations the paged attention must move and do for
    this run's lens: each visible key's K and V row read once (as codes
    plus one f32 scale per visible page and KV head under int8), q read and
    out written once, the page-table entries and lens read once; the
    products of q.k and p.v over every visible key of every query row, and
    under int8 one dequantizing product per visible K/V element."""
    S = len(lens)
    keys = [n + W for n in lens]
    n_vis = [min(P, -(-k // ps)) for k in keys]
    bytes_ = (sum(keys) * kvh * hd * 2 * kv_item + 2 * S * W * h * hd * q_item
              + 4 * sum(n_vis) + 4 * S)
    rows_keys = sum(n + w + 1 for n in lens for w in range(W))
    flops = 2 * 2 * hd * h * rows_keys
    if scales:
        bytes_ += 2 * 4 * kvh * sum(n_vis)
        flops += 2 * kvh * hd * sum(keys)
    return bytes_, flops


def int8_pools(kp, vp):
    """int8 codes and per-page, per-head scales of f32 pools, quantized as
    the engine's admission quantizes whole pages."""
    from paddlepaddle_tpu_torch.inference.decode_engine import _kv_quant_pages

    kq, ks = _kv_quant_pages(kp.float())
    vq, vs = _kv_quant_pages(vp.float())
    return kq, ks, vq, vs


def dequantized(codes, scale):
    return (codes.float() * scale[:, None, :, None]).contiguous()


def phase_kernel_int8():
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(1)
    small = []
    bit_equal_diff = 0.0
    for hd in (64, 128):
        for W in (1, 3):
            q, kp, vp, ptab, lens = paged_inputs(
                rng, 4, W, 8, 2, hd, 16, 3, [5, 13, 0, 40], torch.float32,
                zero_rows=(2,))
            kq, ks, vq, vs = int8_pools(kp, vp)
            zero = int(ptab[0, 0])                 # a zero-scale page in use
            for c, sc in ((kq, ks), (vq, vs)):
                c[zero] = 0
                sc[zero] = 0.0
            kw = dict(rep=4, scale=hd ** -0.5)
            for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                qd = q.to(dtype)
                got = pa.paged_attention(qd, kq, vq, ptab, lens, k_scale=ks,
                                         v_scale=vs, **kw)
                want = pa.paged_attention_plain(qd, kq, vq, ptab, lens,
                                                k_scale=ks, v_scale=vs, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                case = {"hd": hd, "W": W, "dtype": str(dtype)[6:],
                        "max_abs_err": err, "atol": atol}
                if dtype == torch.float32:
                    one = pa.paged_attention(qd, dequantized(kq, ks),
                                             dequantized(vq, vs), ptab, lens,
                                             **kw)
                    torch.cuda.synchronize()
                    diff = float((got - one).abs().max())
                    case["vs_kernel1_dequantized"] = diff
                    bit_equal_diff = max(bit_equal_diff, diff)
                    if not diff <= atol:
                        raise AssertionError(
                            f"int8 kernel vs kernel 1 over dequantized pools "
                            f"hd={hd} W={W}: {diff} > {atol}")
                small.append(case)
                if not err <= atol:
                    raise AssertionError(f"paged_attention int8 small shape "
                                         f"hd={hd} W={W} {dtype}: err {err} "
                                         f"> {atol}")
    # the context split (P 32 pages of 16, lens across split boundaries, W 1,
    # 2 and 4): against the plain version, and at q f32 against kernel 1
    # over the dequantized pools, which takes the same splits (own seed, so
    # the main shape draws the same lens as before the split)
    split_rng = np.random.default_rng(11)
    for (S_, h_, kvh_), hd, W in itertools.product(
            ((6, 8, 2), (8, 32, 8)), (64, 128), (1, 2, 4)):
        lens_s, n_split_s, pps_s = split_lens(pa, S_, kvh_, 16, 32, W)
        lens_s = (lens_s * 2)[:S_]
        q, kp, vp, ptab, lens = paged_inputs(
            split_rng, S_, W, h_, kvh_, hd, 16, 32, lens_s, torch.float32,
            zero_rows=(1,))
        kq, ks, vq, vs = int8_pools(kp, vp)
        kw = dict(rep=h_ // kvh_, scale=hd ** -0.5)
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            qd = q.to(dtype)
            got = pa.paged_attention(qd, kq, vq, ptab, lens, k_scale=ks,
                                     v_scale=vs, **kw)
            want = pa.paged_attention_plain(qd, kq, vq, ptab, lens,
                                            k_scale=ks, v_scale=vs, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            case = {"S": S_, "kvh": kvh_, "hd": hd, "W": W,
                    "dtype": str(dtype)[6:], "P": 32, "lens": lens_s,
                    "n_split": n_split_s, "pages_per_split": pps_s,
                    "max_abs_err": err, "atol": atol}
            if dtype == torch.float32:
                one = pa.paged_attention(qd, dequantized(kq, ks),
                                         dequantized(vq, vs), ptab, lens,
                                         **kw)
                torch.cuda.synchronize()
                diff = float((got - one).abs().max())
                case["vs_kernel1_dequantized"] = diff
                bit_equal_diff = max(bit_equal_diff, diff)
                if not diff <= atol:
                    raise AssertionError(
                        f"int8 kernel vs kernel 1 over dequantized pools "
                        f"(split case) S={S_} hd={hd} W={W}: {diff} > "
                        f"{atol}")
            small.append(case)
            if not err <= atol:
                raise AssertionError(f"paged_attention int8 split case "
                                     f"S={S_} hd={hd} W={W} {dtype}: err "
                                     f"{err} > {atol}")
    lib = pa._library()
    for ps_, hd_, rows, item in ((64, 128, 4, 1), (16, 64, 12, 1),
                                 (64, 128, 4, 2), (16, 64, 12, 4),
                                 (64, 128, 32, 4), (16, 64, 3, 2)):
        if lib.paged_attention_smem_bytes(item, hd_, ps_, rows) != \
                pa.smem_bytes(ps_, hd_, rows, item):
            raise AssertionError("paged attention: Python and CUDA disagree "
                                 "on shared memory")

    # main-path shape: the serve_int8 decode step (Llama-3-8B, 8 slots)
    S, W, h, kvh, hd, ps, P = 8, 1, 32, 8, 128, 64, 32
    lens = rng.integers(64, 2001, S).tolist()
    q, kp, vp, ptab, lens_t = paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens,
                                           torch.bfloat16)
    kq, ks, vq, vs = int8_pools(kp, vp)
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    qargs = (q, kq, vq, ptab, lens_t)
    qkw = dict(kw, k_scale=ks, v_scale=vs)
    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(q.device))
    got = pa.paged_attention(*qargs, **qkw)
    want = pa.paged_attention_plain(*qargs, **qkw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"paged_attention int8 main shape: err {err} "
                             "> 2e-2")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = median_ms(lambda: pa.paged_attention(*qargs, **qkw),
                          flush=flush)
    kernel1_ms = median_ms(lambda: pa.paged_attention(q, kp, vp, ptab, lens_t,
                                                      **kw), flush=flush)
    plain_ms = median_ms(lambda: pa.paged_attention_plain(*qargs, **qkw),
                         flush=flush)
    wrapper_us = host_us(lambda: pa.paged_attention(*qargs, **qkw))
    # yardstick only, not one library call: dequantize the gathered pages to
    # bf16, then SDPA over the view
    T = P * ps
    idx = ptab.long()
    k_pos = torch.arange(T, device="cuda")
    q_pos = lens_t.long()[:, None] + torch.arange(W, device="cuda")[None, :]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # [S,1,W,T]
    qs = q.transpose(1, 2).contiguous()                       # [S, h, W, hd]

    def composition():
        views = []
        for c, sc in ((kq, ks), (vq, vs)):
            d = (c[idx].float() * sc[idx][:, :, None, :, None]).to(q.dtype)
            views.append(d.reshape(S, T, kvh, hd).transpose(1, 2))
        return tF.scaled_dot_product_attention(
            qs, views[0], views[1], attn_mask=mask, scale=kw["scale"],
            enable_gqa=True)

    composition_ms = median_ms(composition, flush=flush)
    del flush
    bytes_, flops = paged_work(lens, W, h, kvh, hd, ps, P, q.element_size(),
                               1, scales=True)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    record = {
        "name": "paged_attention_int8", "route": "cuda",
        "source": PAGED_SOURCE,
        "replaces": PAGED_REPLACES + " (quantized)",
        "launches": None, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"S{S} W{W} h{h} kvh{kvh} hd{hd} ps{ps} bf16 q, int8 pools, "
                 f"lens {min(lens)}-{max(lens)}",
        "bytes": bytes_, "flops": flops}
    emit({"phase": "kernel_int8", "small": small,
          "max_diff_vs_kernel1_dequantized": bit_equal_diff,
          "bit_equal_vs_kernel1_dequantized": bit_equal_diff == 0.0,
          "main_shape": record["shape"], "n_split": n_split,
          "pages_per_split": pps, "lens": lens, "max_abs_err": err,
          "kernel_ms": kernel_ms, "kernel1_bf16_pools_ms": kernel1_ms,
          "plain_ms": plain_ms, "composition_ms": composition_ms,
          "wrapper_host_us": wrapper_us, "bound_ms": record["bound_ms"],
          "bound_share": record["bound_ms"] / kernel_ms})
    return record


def flash_inputs(rng, b, sq, sk, h, d, dtype):
    """q, k, v, dO on the card from numpy normals."""
    import numpy as np
    import torch

    shapes = ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
            .to("cuda", dtype) for sh in shapes]


def flash_check(fa, q, k, v, do, causal):
    """Each kernel against the plain version's forward and its autograd
    backward on the same inputs: max abs error of out, lse, dq, dk, dv.
    The backward kernels get the forward kernel's lse and the delta of the
    kernel's out, as in training."""
    import torch

    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out_p, lse_p = fa.flash_attention_plain(qr, kr, vr, causal, scale)
    grads = torch.autograd.grad(out_p, (qr, kr, vr), do)
    torch.cuda.synchronize()

    def err(a, b_):
        return float((a.detach().float() - b_.detach().float()).abs().max())

    return {"out": err(out, out_p), "lse": err(lse, lse_p),
            "dq": err(dq, grads[0]), "dk": err(dk, grads[1]),
            "dv": err(dv, grads[2])}


def flash_work(q, k, causal):
    """Bytes each kernel must move and the products it must do at these
    shapes: every input read once, every output written once; U = 2 b h d
    times the visible (query, key) pairs, and the forward does 2U, dQ 3U,
    dK/dV 4U."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    off = sk - sq
    pairs = (sum(min(i + off + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    U = 2 * b * h * d * pairs
    item = q.element_size()
    t_q, t_k = q.numel() * item, k.numel() * item
    rows = 4 * b * h * sq                         # one f32 lse / delta row set
    return {"flash_fwd": (t_q + 2 * t_k + t_q + rows, 2 * U),
            "flash_bwd_dq": (2 * t_q + 2 * t_k + 2 * rows + t_q, 3 * U),
            "flash_bwd_dkv": (2 * t_q + 2 * t_k + 2 * rows + 2 * t_k, 4 * U)}


def phase_flash_kernel():
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    small = []
    for d in (64, 128):
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for causal in (True, False):
                shapes = ((128, 128), (64, 192), (100, 100))
                if dtype == torch.bfloat16:      # the TMA/wgmma kernels
                    shapes += ((1, 2048), (130, 130), (200, 333), (257, 257))
                for sq, sk in shapes:
                    q, k, v, do = flash_inputs(rng, 2, sq, sk, 3, d, dtype)
                    errs = flash_check(fa, q, k, v, do, causal)
                    small.append({"d": d, "dtype": str(dtype)[6:],
                                  "causal": causal, "sq": sq, "sk": sk,
                                  "atol": atol, **errs})
                    if not max(errs.values()) <= atol:
                        raise AssertionError(
                            f"flash kernels small shape d={d} {dtype} causal="
                            f"{causal} sq={sq} sk={sk}: {errs} > {atol}")

    # what the JAX package computes without a TPU kernel (d outside its gate,
    # causal s_q > s_k) takes the plain version on the card too: it answers
    # (it raised before) within 1e-5 of the CPU, and launches no kernel
    from paddlepaddle_tpu_torch.nn import functional as pF

    routes = []
    before = fa.flash_fwd.launches
    for d, causal, sq, sk in ((96, True, 48, 48), (96, False, 40, 72),
                              (128, True, 64, 32)):
        q, k, v, _ = flash_inputs(rng, 2, sq, sk, 2, d, torch.float32)
        got = pF.flash_attention(q, k, v, causal=causal)[0]
        want = pF.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                  causal=causal)[0]
        err = float((got.cpu() - want).abs().max())
        routes.append({"d": d, "causal": causal, "sq": sq, "sk": sk,
                       "max_abs_err": err})
        if not err <= 1e-5:
            raise AssertionError(f"plain route on the card d={d} causal="
                                 f"{causal} sq={sq} sk={sk}: err {err}")
    if fa.flash_fwd.launches != before:
        raise AssertionError("a plain route launched the forward kernel")

    # main-path shape: one Llama-3-8B layer of the train phase (b 4, s 2048,
    # 32 heads after the GQA repeat, d 128, bf16, causal)
    b, s, h, d = 4, 2048, 32, 128
    q, k, v, do = flash_inputs(rng, b, s, s, h, d, torch.bfloat16)
    errs = flash_check(fa, q, k, v, do, True)
    main_atol = 2e-2
    if not max(errs.values()) <= main_atol:
        raise AssertionError(f"flash kernels main shape: {errs} > {main_atol}")
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(out, do)
    # one writer per output row, no atomics: two launches of the backward
    # pair give the same bits
    first = (fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale))
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale))
    repeat_equal = all(torch.equal(a, b_) for a, b_ in zip(first, again))
    if not repeat_equal:
        raise AssertionError("flash backward pair: two launches differ")
    del first, again
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = {
        "flash_fwd": median_ms(lambda: fa.flash_fwd(q, k, v, True, scale),
                               flush=flush),
        "flash_bwd_dq": median_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, True, scale), flush=flush),
        "flash_bwd_dkv": median_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, scale), flush=flush),
    }
    plain_fwd = median_ms(lambda: fa.flash_attention_plain(q, k, v, True,
                                                           scale),
                          reps=10, flush=flush)
    # one plain pass computes dq, dk and dv together: it is the plain
    # version of both backward kernels
    plain_bwd = median_ms(lambda: fa.flash_bwd_plain(
        q, k, v, do, lse, delta, True, scale), reps=10, flush=flush)
    # yardstick only: SDPA on [b, h, s, d]; its backward computes the pair
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = median_ms(lambda: tF.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), flush=flush)
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qh, kh, vh))
    og = tF.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), doh, retain_graph=True), flush=flush)
    del flush
    work = flash_work(q, k, True)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    err_of = {"flash_fwd": max(errs["out"], errs["lse"]),
              "flash_bwd_dq": errs["dq"],
              "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    records = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        bytes_, flops = work[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": FLASH_FWD_SOURCE if name == "flash_fwd"
            else FLASH_BWD_SOURCE,
            "replaces": FLASH_REPLACES[name], "launches": None,
            "max_abs_err": err_of[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name],
            "shape": f"b{b} s{s} h{h} d{d} bf16 causal",
            "bytes": bytes_, "flops": flops})
    emit({"phase": "flash_kernel", "small_cases": len(small),
          "plain_routes": routes,
          "small_max_err": {dt: max(max(c[k] for k in ("out", "lse", "dq",
                                                       "dk", "dv"))
                                    for c in small if c["dtype"] == dt)
                            for dt in ("float32", "bfloat16")},
          "main_shape": records[0]["shape"], "main_errs": errs,
          "main_atol": main_atol, "bwd_repeat_bit_identical": repeat_equal,
          "ms": ms, "plain_ms": plain, "library_ms": library,
          "bound_ms": {r["name"]: r["bound_ms"] for r in records},
          "tflops": {r["name"]: r["flops"] / r["ms"] / 1e9 for r in records},
          "bound_share": {r["name"]: r["bound_ms"] / r["ms"]
                          for r in records}})
    return records


# packed varlen attention (kernels 5-7): small layouts as (lens_q, lens_k or
# None for lens_q, t_q, t_k); t past a sum is a padding tail
VARLEN_SMALL = {
    "pad_empty": ([0, 5, 9, 0, 3, 20, 0], None, 48, 48),
    "prefill": ([4, 6, 8, 3], [11, 6, 20, 9], 24, 48),
    "qlong": ([0, 12, 5, 6], [0, 5, 0, 9], 24, 16),
    "ones": ([1] * 64, None, 67, 67),
    "mixed": ([3, 40, 7, 0, 5, 9, 100], [3, 40, 7, 2, 5, 9, 100], 171, 173),
    "multi": ([700, 0, 129], [900, 64, 129], 837, 1101),
    # only 128-row tiles reach these: a tile over three segments and a
    # segment longer than 3 stages of 128 keys; len_k > len_q over several
    # key tiles with t_q % 4 != 0
    "tile128": ([100, 156, 1, 300, 0, 211], None, 800, 800),
    "prefill128": ([130, 7, 260], [900, 7, 700], 397, 1607),
    # the bf16 dQ's first 64-row consumer over three segments, whose keys
    # start inside a 64-key tile
    "consumer3": ([10, 20, 40, 90], [37, 20, 70, 90], 170, 230),
}


def varlen_cu(lens):
    import numpy as np

    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def varlen_pairs(cu_q, cu_k, causal: bool) -> int:
    """Visible (query, key) pairs of one head: per segment, every pair, or
    under causal masking min(len_k, i + len_k - len_q + 1) keys for row i."""
    import numpy as np

    total = 0
    for lq, lk in zip(np.diff(cu_q).tolist(), np.diff(cu_k).tolist()):
        if causal:
            i = np.arange(lq)
            total += int(np.clip(i + lk - lq + 1, 0, lk).sum())
        else:
            total += lq * lk
    return total


def varlen_tiles(fv, cq, ck, tq, tk, causal, bm=128, bn=128):
    """Key tiles of ``bn`` a CTA of ``bm`` query rows must stream to cover
    its rows' visible keys (from its first visible key to its last), summed
    over the CTAs, beside the tiles a loop over all of t_k takes."""
    import torch
    import torch.nn.functional as tF

    mask = fv.varlen_mask(cq, ck, tq, tk, causal)
    cols = torch.arange(tk, device=mask.device)
    first = torch.where(mask, cols, tk).min(1).values
    last = torch.where(mask, cols + 1, 0).max(1).values
    pad = (-tq) % bm
    first = tF.pad(first, (0, pad), value=tk).view(-1, bm).min(1).values
    last = tF.pad(last, (0, pad), value=0).view(-1, bm).max(1).values
    visited = int(((last - first).clamp(min=0) + bn - 1).div(
        bn, rounding_mode="floor").sum())
    return {"visited": visited,
            "all_of_t": -(-tq // bm) * -(-tk // bn)}


def varlen_launches():
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    return {"varlen_fwd": fv.varlen_fwd.launches,
            "varlen_bwd_dq": fv.varlen_bwd_dq.launches,
            "varlen_bwd_dkv": fv.varlen_bwd_dkv.launches}


def reset_varlen_launches() -> None:
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    fv.varlen_fwd.launches = 0
    fv.varlen_bwd_dq.launches = 0
    fv.varlen_bwd_dkv.launches = 0


def varlen_reference(fv, q, k, v, do, cq, ck, causal, got):
    """The plain versions on the same inputs as the kernels: the forward on
    q, k, v; the backward on the kernels' own lse and the delta of their
    out, as the backward kernels get them. Heads go in chunks."""
    scale = q.shape[-1] ** -0.5
    out, lse = fv.varlen_attention_plain(q, k, v, cq, ck, causal, scale)
    delta = fv.varlen_delta(got["out"], do)
    dq, dk, dv = fv.varlen_bwd_plain(q, k, v, do, got["lse"], delta, cq, ck,
                                     causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def varlen_compare(fv, got, want, cq, ck, causal, atol, rtol=0.0):
    """Max abs error of each tensor (lse on rows that see a key) and the
    excess over ``atol + rtol * |want|``; raises unless rows that see no
    key have out and dq exactly 0 and lse -1e30, and keys no row sees have
    dk and dv exactly 0."""
    tq, tk = got["out"].shape[0], got["dk"].shape[0]
    mask = fv.varlen_mask(cq, ck, tq, tk, causal)
    row_ok, key_ok = mask.any(1), mask.any(0)
    errs, excess = {}, {}
    for name in ("out", "lse", "dq", "dk", "dv"):
        a, b_ = got[name].detach().float(), want[name].detach().float()
        if name == "lse":
            a, b_ = a[:, row_ok], b_[:, row_ok]
        diff = (a - b_).abs()
        errs[name] = float(diff.max()) if diff.numel() else 0.0
        excess[name] = (float((diff - atol - rtol * b_.abs()).max())
                        if diff.numel() else -atol)
    zero = (bool((got["out"][~row_ok] == 0).all())
            and bool((got["dq"][~row_ok] == 0).all())
            and bool((got["lse"][:, ~row_ok] == -1e30).all())
            and bool((got["dk"][~key_ok] == 0).all())
            and bool((got["dv"][~key_ok] == 0).all()))
    if not zero:
        raise AssertionError("varlen kernels: a row without a key or a key "
                             "without a row is not exactly 0")
    return errs, excess, int((~row_ok).sum()), int((~key_ok).sum())


def varlen_kernels(fv, q, k, v, do, cq, ck, causal):
    scale = q.shape[-1] ** -0.5
    out, lse = fv.varlen_fwd(q, k, v, cq, ck, causal, scale)
    delta = fv.varlen_delta(out, do)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, cq, ck, causal, scale)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, cq, ck, causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def packed_batch(rng, total, lo, hi):
    """Segment lengths drawn from [lo, hi] until they sum to ``total`` (the
    last one cut to fit)."""
    lens = []
    while sum(lens) < total:
        lens.append(int(min(rng.integers(lo, hi + 1), total - sum(lens))))
    return lens


def varlen_library_call(q, k, v, do, cu, causal):
    """One PyTorch call computing the same function, for timing only:
    SDPA over ``torch.nested`` jagged tensors of the non-empty segments if
    this torch takes them (causal, forward and backward), else SDPA with the
    block-diagonal (and causal) boolean mask over the valid tokens. Returns
    (name, forward giving out [valid, h, d], backward of one output)."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    n = int(cu[-1])
    leaves = [x[:n].detach().clone().requires_grad_(True) for x in (q, k, v)]
    do = do[:n]

    def backward(out):
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    offs = torch.tensor(sorted(set(cu.tolist())), dtype=torch.int64,
                        device=q.device)
    try:
        nts = [torch.nested.nested_tensor_from_jagged(x, offs).transpose(1, 2)
               for x in leaves]

        def njt():
            o = tF.scaled_dot_product_attention(*nts, is_causal=causal)
            return o.transpose(1, 2).values()

        backward(njt())
        return "sdpa_nested_jagged", njt, backward
    except (RuntimeError, NotImplementedError, ValueError, TypeError):
        pass
    seg = torch.repeat_interleave(
        torch.arange(len(cu) - 1, device=q.device),
        torch.from_numpy(np.diff(cu)).to(q.device))
    mask = seg[:, None] == seg[None, :]
    if causal:
        mask &= torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    qh, kh, vh = (x.transpose(0, 1).unsqueeze(0) for x in leaves)

    def masked():
        o = tF.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        return o[0].transpose(0, 1)

    return "sdpa_block_diagonal_mask", masked, backward


def phase_flash_varlen_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.incubate.nn import functional as incF
    from paddlepaddle_tpu_torch.nn import functional as F
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    rng = np.random.default_rng(0)
    dev = "cuda"

    def normals(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    # small cases: every layout, d 64 / 128, f32 / bf16, causal and full
    small = []
    for name, (lens_q, lens_k, tq, tk) in VARLEN_SMALL.items():
        cu_q = varlen_cu(lens_q)
        cu_k = cu_q if lens_k is None else varlen_cu(lens_k)
        cq, ck = (torch.from_numpy(c).to(dev) for c in (cu_q, cu_k))
        for d in (64, 128):
            # bf16 adds 1e-2 relative: gradients reach |x| >= 4 (a causal
            # segment's first keys sum dO over ~100 rows), where one bf16
            # ulp (2^-7 relative at the bottom of a binade) is 0.031
            for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0),
                                      (torch.bfloat16, 2e-2, 1e-2)):
                for causal in (True, False):
                    q, do = (normals(tq, 3, d, dtype=dtype) for _ in range(2))
                    k, v = (normals(tk, 3, d, dtype=dtype) for _ in range(2))
                    got = varlen_kernels(fv, q, k, v, do, cq, ck, causal)
                    want = varlen_reference(fv, q, k, v, do, cq, ck, causal,
                                            got)
                    torch.cuda.synchronize()
                    errs, excess, dead_rows, dead_keys = varlen_compare(
                        fv, got, want, cq, ck, causal, atol, rtol)
                    small.append({"layout": name, "d": d,
                                  "dtype": str(dtype)[6:], "causal": causal,
                                  "atol": atol, "rtol": rtol,
                                  "rows_without_key": dead_rows,
                                  "keys_without_row": dead_keys, **errs})
                    if max(excess.values()) > 0:
                        raise AssertionError(
                            f"varlen kernels small case {name} d={d} {dtype} "
                            f"causal={causal}: {errs} beyond atol {atol} + "
                            f"rtol {rtol}")

    # one segment over the whole buffer is dense attention at [1, s, h, d]
    cross, cross_dq = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            s, h, d = 1000, 4, 128
            q, k, v, do = (normals(s, h, d, dtype=dtype) for _ in range(4))
            cu = torch.tensor([0, s], dtype=torch.int32, device=dev)
            got = varlen_kernels(fv, q, k, v, do, cu, cu, causal)
            b4 = [x.unsqueeze(0) for x in (q, k, v, do)]
            out, lse = fa.flash_fwd(*b4[:3], causal, d ** -0.5)
            delta = fa.flash_delta(out, b4[3])
            dq = fa.flash_bwd_dq(*b4, lse, delta, causal, d ** -0.5)
            dk, dv = fa.flash_bwd_dkv(*b4, lse, delta, causal, d ** -0.5)
            dense = {"out": out[0], "lse": lse, "dq": dq[0], "dk": dk[0],
                     "dv": dv[0]}
            torch.cuda.synchronize()
            key = f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"
            diffs = {n: float((got[n].float() - dense[n].float()).abs()
                              .max()) for n in dense}
            cross[key], cross_dq[key] = max(diffs.values()), diffs["dq"]
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            if not cross[key] <= tol:
                raise AssertionError(f"varlen vs dense kernels {key}: "
                                     f"{cross[key]} > {tol}")

    # the main path at full width: Llama-3-8B attention (h 32, d 128, bf16)
    # through the public entry points, counters from 0
    h, d = 32, 128
    bf = torch.bfloat16
    lens_a = packed_batch(np.random.default_rng(0), 8192, 64, 2048)
    lens_a.insert(len(lens_a) // 2, 0)               # one empty segment
    cu_a = varlen_cu(lens_a)
    t_a = int(cu_a[-1]) + 64                          # 64-row padding tail
    qa, ka, va = (normals(t_a, h, d, dtype=bf) for _ in range(3))
    proj_a = normals(t_a, h, d, dtype=torch.float32)
    ctx_b = [int(x) for x in rng.integers(512, 4097, 8)]
    cu_bq = varlen_cu([256] * 8)
    cu_bk = varlen_cu(ctx_b)
    qb = normals(int(cu_bq[-1]), h, d, dtype=bf)
    kb, vb = (normals(int(cu_bk[-1]), h, d, dtype=bf) for _ in range(2))
    proj_b = normals(int(cu_bq[-1]), h, d, dtype=torch.float32)
    b_c, s_c = 8, 2048
    lens_c = np.array([int(x) for x in rng.integers(64, 2049, b_c)])
    qc, kc, vc = (normals(b_c, h, s_c, d, dtype=bf) for _ in range(3))
    leaves_a = [x.clone().requires_grad_(True) for x in (qa, ka, va)]
    leaves_b = [x.clone().requires_grad_(True) for x in (qb, kb, vb)]
    torch.cuda.synchronize()

    reset_varlen_launches()
    t0 = time.perf_counter()
    out_a, _ = F.flash_attn_unpadded(*leaves_a, cu_a, cu_a, causal=True)
    (out_a.float() * proj_a).sum().backward()
    after_a = varlen_launches()
    out_b, _ = F.flash_attn_unpadded(*leaves_b, cu_bq, cu_bk, causal=True)
    (out_b.float() * proj_b).sum().backward()
    out_c = incF.variable_length_memory_efficient_attention(
        qc, kc, vc, lens_c, lens_c)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = varlen_launches()
    if after_a != {"varlen_fwd": 1, "varlen_bwd_dq": 1, "varlen_bwd_dkv": 1}:
        raise AssertionError(f"(a) moved the varlen counters by {after_a}, "
                             "expected 1 each")
    if launches != {"varlen_fwd": 3, "varlen_bwd_dq": 2, "varlen_bwd_dkv": 2}:
        raise AssertionError(f"varlen main path launched {launches}")

    full_atol, full_rtol = 2e-2, 1e-2
    checks = {}
    for key, leaves, out, proj, cq_np, ck_np in (
            ("a_packed", leaves_a, out_a, proj_a, cu_a, cu_a),
            ("b_prefill", leaves_b, out_b, proj_b, cu_bq, cu_bk)):
        cq, ck = (torch.from_numpy(c).to(dev) for c in (cq_np, ck_np))
        do = proj.to(bf)
        q, k, v = (x.detach() for x in leaves)
        # the lse the public path's backward used (the forward kernel is
        # deterministic)
        lse = fv.varlen_fwd(q, k, v, cq, ck, True, d ** -0.5)[1]
        got = {"out": out.detach(), "lse": lse, "dq": leaves[0].grad,
               "dk": leaves[1].grad, "dv": leaves[2].grad}
        want = varlen_reference(fv, q, k, v, do, cq, ck, True, got)
        errs, excess, dead_rows, dead_keys = varlen_compare(
            fv, got, want, cq, ck, True, full_atol, full_rtol)
        checks[key] = {"errs": errs, "rows_without_key": dead_rows,
                       "keys_without_row": dead_keys,
                       "max_abs_grad": max(float(want[n].float().abs().max())
                                           for n in ("dq", "dk", "dv"))}
        del want
        if max(excess.values()) > 0:
            raise AssertionError(f"varlen full width {key}: {errs} beyond "
                                 f"atol {full_atol} + rtol {full_rtol}")
    # (a) in f32: the kernels' masking and tiling at full width, free of
    # the bf16 rounding of p and ds that the bf16 check above allows for
    cq = torch.from_numpy(cu_a).to(dev)
    q32, k32, v32 = (x.detach().float() for x in leaves_a)
    do32 = proj_a
    got = varlen_kernels(fv, q32, k32, v32, do32, cq, cq, True)
    want = varlen_reference(fv, q32, k32, v32, do32, cq, cq, True, got)
    errs, excess, _, _ = varlen_compare(fv, got, want, cq, cq, True, 1e-5)
    checks["a_packed_f32"] = {"errs": errs}
    del got, want, q32, k32, v32
    if max(excess.values()) > 0:
        raise AssertionError(f"varlen full width a_packed in f32: {errs} > "
                             "1e-5")
    # (c): the padded batch against the plain forward of each sequence
    err_c = 0.0
    for i in range(b_c):
        n = int(lens_c[i])
        cu = torch.tensor([0, n], dtype=torch.int32, device=dev)
        ref, _ = fv.varlen_attention_plain(
            *(x[i, :, :n].transpose(0, 1) for x in (qc, kc, vc)), cu, cu,
            False, d ** -0.5)
        err_c = max(err_c, float((out_c[i, :, :n].transpose(0, 1).float()
                                  - ref.float()).abs().max()))
        if not bool((out_c[i, :, n:] == 0).all()):
            raise AssertionError("incubate varlen: rows past a length not 0")
    checks["c_incubate"] = {"out": err_c}
    if not err_c <= full_atol:
        raise AssertionError(f"incubate varlen at full width: {err_c}")
    del out_b, leaves_b, qc, kc, vc, out_c

    # timings at (a): the kernels on their own inputs, L2 flushed
    cq = torch.from_numpy(cu_a).to(dev)
    do_a = proj_a.to(bf)
    scale = d ** -0.5
    out, lse = fv.varlen_fwd(qa, ka, va, cq, cq, True, scale)
    delta = fv.varlen_delta(out, do_a)
    # one writer per output row, no atomics: two launches of dQ, and two of
    # dK/dV, give the same bits
    first = fv.varlen_bwd_dq(qa, ka, va, do_a, lse, delta, cq, cq, True,
                             scale)
    again = fv.varlen_bwd_dq(qa, ka, va, do_a, lse, delta, cq, cq, True,
                             scale)
    dq_repeat_equal = torch.equal(first, again)
    first = fv.varlen_bwd_dkv(qa, ka, va, do_a, lse, delta, cq, cq, True,
                              scale)
    again = fv.varlen_bwd_dkv(qa, ka, va, do_a, lse, delta, cq, cq, True,
                              scale)
    dkv_repeat_equal = all(torch.equal(a, b_) for a, b_ in zip(first, again))
    del first, again
    if not dq_repeat_equal:
        raise AssertionError("varlen dQ: two launches differ")
    if not dkv_repeat_equal:
        raise AssertionError("varlen dK/dV: two launches differ")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = {
        "varlen_fwd": median_ms(lambda: fv.varlen_fwd(
            qa, ka, va, cq, cq, True, scale), flush=flush),
        "varlen_bwd_dq": median_ms(lambda: fv.varlen_bwd_dq(
            qa, ka, va, do_a, lse, delta, cq, cq, True, scale), flush=flush),
        "varlen_bwd_dkv": median_ms(lambda: fv.varlen_bwd_dkv(
            qa, ka, va, do_a, lse, delta, cq, cq, True, scale), flush=flush),
    }
    plain_fwd = median_ms(lambda: fv.varlen_attention_plain(
        qa, ka, va, cq, cq, True, scale), reps=5, warmup=1, flush=flush)
    # one plain pass computes dq, dk and dv together: it is the plain
    # version of both backward kernels
    plain_bwd = median_ms(lambda: fv.varlen_bwd_plain(
        qa, ka, va, do_a, lse, delta, cq, cq, True, scale), reps=5, warmup=1,
        flush=flush)
    lib_name, lib_fn, lib_bwd_fn = varlen_library_call(qa, ka, va, do_a,
                                                       cu_a, True)
    n_valid = int(cu_a[-1])
    lib_out = lib_fn()
    lib_err = float((lib_out.detach().float() - out[:n_valid].float()).abs()
                    .max())
    lib_fwd = median_ms(lib_fn, flush=flush)
    lib_bwd = median_ms(lambda: lib_bwd_fn(lib_out), flush=flush)
    del flush

    pairs = varlen_pairs(cu_a, cu_a, True) * h
    tiles = varlen_tiles(fv, cq, cq, t_a, t_a, True)
    item = 2
    t_q = t_a * h * d * item
    rows = 4 * h * t_a
    work = {"varlen_fwd": (4 * t_q + rows, 4 * d * pairs),
            "varlen_bwd_dq": (5 * t_q + 2 * rows, 6 * d * pairs),
            "varlen_bwd_dkv": (6 * t_q + 2 * rows, 8 * d * pairs)}
    plain = {"varlen_fwd": plain_fwd, "varlen_bwd_dq": plain_bwd,
             "varlen_bwd_dkv": plain_bwd}
    library = {"varlen_fwd": lib_fwd, "varlen_bwd_dq": lib_bwd,
               "varlen_bwd_dkv": lib_bwd}
    errs_a = checks["a_packed"]["errs"]
    err_of = {"varlen_fwd": max(errs_a["out"], errs_a["lse"]),
              "varlen_bwd_dq": errs_a["dq"],
              "varlen_bwd_dkv": max(errs_a["dk"], errs_a["dv"])}
    shape = (f"t {t_a} ({len(lens_a)} segments, one empty, 64-row tail) "
             f"h{h} d{d} bf16 causal")
    records = []
    for name in ("varlen_fwd", "varlen_bwd_dq", "varlen_bwd_dkv"):
        bytes_, flops = work[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda", "source": VARLEN_SOURCES[name],
            "replaces": VARLEN_REPLACES[name], "launches": launches[name],
            "max_abs_err": err_of[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name], "library": lib_name,
            "shape": shape, "bytes": bytes_, "flops": flops})
    emit({"phase": "flash_varlen_kernel", "small_cases": len(small),
          "small_max_err": {dt: max(max(c[k] for k in ("out", "lse", "dq",
                                                       "dk", "dv"))
                                    for c in small if c["dtype"] == dt)
                            for dt in ("float32", "bfloat16")},
          "dense_cross_check_max_diff": cross,
          "dense_cross_check_dq": cross_dq,
          "segments_a": lens_a, "contexts_b": ctx_b,
          "seq_lens_c": lens_c.tolist(), "main_path_s": main_s,
          "launches": launches, "full_width": checks,
          "full_atol": full_atol, "full_rtol": full_rtol,
          "visible_pairs_a": pairs, "fwd_tiles_a": tiles,
          "dq_repeat_bit_identical": dq_repeat_equal,
          "dkv_repeat_bit_identical": dkv_repeat_equal,
          "ptxas": {k: v for src in ("flash_varlen_sm90", "flash_varlen")
                    for k, v in ptxas_kernels(str(_build.build_log.get(
                        src, {}).get("ptxas", ""))).items()},
          "ms": ms, "plain_ms": plain, "library": lib_name,
          "library_ms": library, "library_max_diff": lib_err,
          "bound_ms": {r["name"]: r["bound_ms"] for r in records},
          "tflops": {r["name"]: r["flops"] / r["ms"] / 1e9 for r in records},
          "bound_share": {r["name"]: r["bound_ms"] / r["ms"]
                          for r in records}})
    return records


def gather_gemm_inputs(rng, T, E, d, h, dtype):
    """x, wg, wu, wd on the card from numpy normals, scaled so that every
    product is of order 1."""
    import numpy as np
    import torch

    x = rng.standard_normal((T, d), dtype=np.float32)
    banks = [rng.standard_normal(sh, dtype=np.float32) / np.sqrt(sh[1])
             for sh in ((E, d, h), (E, d, h), (E, h, d))]
    return [torch.from_numpy(a).to("cuda", dtype) for a in [x] + banks]


def planted_slots(rng, T, E, C, empty=None):
    """Token rows per slot from the port's capacity routing (top-2) of
    planted logits: expert 0 is first for half the tokens (drops when
    T > C), expert ``empty`` is never chosen (all its slots sentinels)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    lg = np.argsort(rng.random((T, E)), axis=1).astype(np.float32)
    lg += rng.uniform(0, 0.1, (T, E)).astype(np.float32)
    lg[: (T + 1) // 2, 0] = E + 1.0
    if empty is not None:
        lg[:, empty] = -10.0
    _, _, _, valid, entry = tmoe._capacity_slot_maps(
        torch.from_numpy(lg).cuda(), 2, E, C, T)
    return torch.where(valid, entry % T, T).to(torch.int32)


def gather_gemm_check(gg, x, slot, wg, wu, wd, C):
    """Each phase against its plain half on the same inputs and the call
    against gather_gemm_ffn_plain: {name: (max abs error, max error /
    allowed)}, allowed 1e-5 in f32; in bf16 each phase's bound (one bf16
    step and its f32 summation-order slack) and the call's derived bound. Every sentinel slot's rows must be zero."""
    import torch

    T = x.shape[0]
    E, _, h = wg.shape
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    hmid_want = gg.gather_gateup_plain(x, slot, wg, wu, capacity=C)
    down = gg.expert_down(hmid_want, slot, wd, n_tokens=T)
    down_want = gg.expert_down_plain(hmid_want, slot, wd, n_tokens=T)
    got = gg.gather_gemm_ffn(x, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    out = {}
    for name, a, b in (("gather_gateup", hmid, hmid_want),
                       ("expert_down", down, down_want),
                       ("call", got, want)):
        err = (a.float() - b.float()).abs()
        if x.dtype == torch.float32:
            allowed = torch.full_like(err, 1e-5)
        elif name == "call":
            allowed = gg.bf16_error_bound(x, slot, wg, wu, wd, capacity=C,
                                          plain=b)
        elif name == "gather_gateup":
            allowed = gg.gather_gateup_bf16_bound(x, slot, wg, wu,
                                                  capacity=C, plain=b)
        else:
            allowed = gg.expert_down_bf16_bound(hmid_want, wd, plain=b)
        out[name] = (float(err.max()), float((err / allowed).max()))
        del err, allowed
    dead = (slot < 0) | (slot >= T)
    if bool(hmid.reshape(E * C, h)[dead].any()) or bool(down[dead].any()) \
            or bool(got[dead].any()):
        raise AssertionError("gather-GEMM: a sentinel slot's row is not zero")
    return out


MOE_E, MOE_C, MOE_T, MOE_D, MOE_H = 64, 320, 8192, 2048, 1408
# Mixtral-8x7B's expert widths (public config of mistralai/Mixtral-8x7B-v0.1:
# hidden 4096, intermediate 14336, 8 experts, top-2) at T 2048 and capacity
# factor 1.25: C = 2048 * 2 / 8 * 1.25 = 640
MIXTRAL_E, MIXTRAL_C, MIXTRAL_T, MIXTRAL_D, MIXTRAL_H = 8, 640, 2048, 4096, \
    14336


def gather_gemm_full_case(gg, tmoe, T, E, C, d, h, seed, plain_reps=10):
    """One bf16 case at full width: slots from a routing of random x through
    a random gate (N(0, 0.02), as the model's init), both phases and the
    call checked, then CUDA-event medians (L2 flushed) of each phase, the
    call, the plain version and the sorted mode's composition, beside the
    bounds of this run's work."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, d, device="cuda", generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(E, d, h, device="cuda", generator=gen).mul_(0.02)
              .to(torch.bfloat16) for _ in range(2))
    wd = torch.randn(E, h, d, device="cuda", generator=gen).mul_(0.02) \
        .to(torch.bfloat16)
    gate_w = torch.randn(d, E, device="cuda", generator=gen).mul_(0.02)
    _, _, _, valid, entry = tmoe._capacity_slot_maps(x.float() @ gate_w, 2,
                                                     E, C, T)
    slot = torch.where(valid, entry % T, T).to(torch.int32)
    checks = gather_gemm_check(gg, x, slot, wg, wu, wd, C)
    bad = {k: v for k, v in checks.items() if not v[1] <= 1.0}
    if bad:
        raise AssertionError(f"gather-GEMM T{T} E{E} C{C} d{d} h{h}: {bad}")
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = {
        "gather_gateup": median_ms(lambda: gg.gather_gateup(
            x, slot, wg, wu, capacity=C), flush=flush),
        "expert_down": median_ms(lambda: gg.expert_down(
            hmid, slot, wd, n_tokens=T), flush=flush),
        "call": median_ms(lambda: gg.gather_gemm_ffn(
            x, slot, wg, wu, wd, capacity=C), flush=flush),
        "plain": median_ms(lambda: gg.gather_gemm_ffn_plain(
            x, slot, wg, wu, wd, capacity=C), reps=plain_reps,
            warmup=1, flush=flush),
        # the sorted mode's composition (index gather, two bmm, silu*mul,
        # bmm): a yardstick, not one library call
        "composition": median_ms(lambda: tmoe._reference_expert_ffn(
            x, entry, valid, wg, wu, wd), flush=flush)}
    wrapper_us = host_us(lambda: gg.gather_gemm_ffn(
        x, slot, wg, wu, wd, capacity=C), reps=50)
    del flush
    # least time for this run's work: every weight read once, each token
    # row that a filled slot reads read once, the slot indices read once,
    # each output written once; the products of the filled slots only. Per
    # phase, hmid is written by the first and read by the second.
    n_valid = int(valid.sum())
    n_rows = int(torch.unique(slot[valid]).numel())
    item = x.element_size()
    w_bytes = E * d * h * item
    hmid_bytes = E * C * h * item
    work = {
        "gather_gateup": (2 * w_bytes + n_rows * d * item + 4 * E * C
                          + hmid_bytes, 2 * n_valid * 2 * d * h),
        "expert_down": (w_bytes + hmid_bytes + 4 * E * C + E * C * d * item,
                        2 * n_valid * d * h),
        "call": (3 * w_bytes + n_rows * d * item + 4 * E * C
                 + E * C * d * item, 2 * n_valid * 3 * d * h)}
    bounds = {}
    for name, (bytes_, flops) in work.items():
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        bounds[name] = {"bytes": bytes_, "flops": flops,
                        "bound_ms_bytes": t_bytes,
                        "bound_ms_operations": t_ops,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bound_share": max(t_bytes, t_ops) / ms[name],
                        "tflops": flops / ms[name] / 1e9}
    return {"shape": f"T{T} E{E} C{C} d{d} h{h} bf16",
            "filled_slots": n_valid, "rows_read": n_rows,
            "checks": {k: {"max_abs_err": v[0], "err_over_allowed": v[1]}
                       for k, v in checks.items()},
            "ms": ms, "bounds": bounds, "wrapper_host_us": wrapper_us,
            "call_over_composition": ms["call"] / ms["composition"]}


def phase_gather_gemm_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    rng = np.random.default_rng(0)
    small = []
    # (T, E, C, d, h, empty): C 40 and 37 are not multiples of the row
    # tile (128 slots bf16, 32 f32) and leave a 64-slot half of sentinels,
    # expert 3 is empty (all its tiles sentinels) and expert 0 overflows;
    # (128, 128) is the smallest (d, h) admitted
    for T, E, C, d, h, empty in ((48, 4, 40, 128, 128, 3),
                                 (300, 6, 37, 256, 384, None),
                                 (1, 2, 4, 128, 256, None)):
        for dtype in (torch.float32, torch.bfloat16):
            x, wg, wu, wd = gather_gemm_inputs(rng, T, E, d, h, dtype)
            slot = planted_slots(rng, T, E, C, empty).cuda()
            checks = gather_gemm_check(gg, x, slot, wg, wu, wd, C)
            small.append({"T": T, "E": E, "C": C, "d": d, "h": h,
                          "dtype": str(dtype)[6:],
                          "max_abs_err": max(v[0] for v in checks.values()),
                          "err_over_allowed": max(v[1]
                                                  for v in checks.values())})
            if not small[-1]["err_over_allowed"] <= 1.0:
                raise AssertionError(f"gather-GEMM small case {small[-1]}: "
                                     f"{checks}")
    plan = {}
    for dtype in (torch.bfloat16, torch.float32):
        for phase in gg.PHASES:
            want = gg.smem_bytes(phase, dtype)
            got = gg.kernel_smem_bytes(phase, dtype)
            plan[f"{phase} {str(dtype)[6:]}"] = got
            if got != want:
                raise AssertionError(f"gather-GEMM: Python ({want}) and CUDA "
                                     f"({got}) disagree on the shared memory "
                                     f"of {phase} in {dtype}")

    main = gather_gemm_full_case(gg, tmoe, MOE_T, MOE_E, MOE_C, MOE_D, MOE_H,
                                 seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = gather_gemm_full_case(gg, tmoe, MIXTRAL_T, MIXTRAL_E,
                                    MIXTRAL_C, MIXTRAL_D, MIXTRAL_H, seed=1,
                                    plain_reps=3)
    gc.collect()
    torch.cuda.empty_cache()
    call = main["bounds"]["call"]
    record = {
        "name": "gather_gemm_ffn", "route": "cuda",
        "source": GATHER_GEMM_SOURCE, "replaces": GATHER_GEMM_REPLACES,
        "launches": None,
        "max_abs_err": main["checks"]["call"]["max_abs_err"],
        "ms": main["ms"]["call"], "plain_ms": main["ms"]["plain"],
        "bound_ms": call["bound_ms"], "bound_by": call["bound_by"],
        "library_ms": None, "shape": main["shape"],
        "bytes": call["bytes"], "flops": call["flops"],
        "note": "launches counts calls; each call is two launches "
                "(gather_gateup_sm90, expert_down_sm90)",
        "phase_ms": {k: main["ms"][k]
                     for k in ("gather_gateup", "expert_down")},
        "composition_ms": main["ms"]["composition"]}
    emit({"phase": "gather_gemm_kernel", "small": small, "smem_plan": plan,
          "main": main, "mixtral": mixtral})
    return record


def phase_engine_parity(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1,
                                        init_std=0.1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    specs = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n, _, _ in specs]
    outs = {}
    launches0 = pa.paged_attention.launches
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = pt_pkg.BatchDecodeEngine(model, max_slots=3, chunk=4,
                                       page_size=16, device=dev)
        reqs = [pt_pkg.GenerationRequest(p, mx, 0.0, 0, e)
                for p, (_, mx, e) in zip(prompts, specs)]
        eng.serve(reqs, timeout=300)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
    launches = pa.paged_attention.launches - launches0
    equal = outs["cuda"] == outs["cpu"]
    emit({"phase": "engine_parity", "equal": equal, "kernel_launches": launches,
          "tokens": sum(len(o) for o in outs["cuda"])})
    if not equal:
        raise AssertionError(f"card vs CPU greedy tokens differ: "
                             f"{outs['cuda']} vs {outs['cpu']}")
    if launches == 0:
        raise AssertionError("card engine never launched the kernel")


def phase_engine_parity_int8(pt_pkg):
    """A tiny fp32 Llama serving int8 KV with prefix requests on one slot
    and a pool of 5 usable pages (page 16): two 32-token prefixes take turns,
    so each admission spills the other's prefix to the host tier and the
    next one restores it. Card and CPU give equal tokens and counters."""
    import numpy as np

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1,
                                        init_std=0.1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    prefixes = [rng.integers(0, 256, (32,)) for _ in range(2)]
    order = (0, 1, 0, 1, 0)
    prompts = [np.concatenate([prefixes[i], rng.integers(0, 256, (9,))])
               for i in order]
    outs, counters = {}, {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = pt_pkg.BatchDecodeEngine(
            model, max_slots=1, chunk=4, page_size=16, num_pages=6,
            kv_quant="int8", kv_host_bytes=1 << 22, device=dev)
        reqs = [pt_pkg.GenerationRequest(p, 8, 0.0, 0, None, prefix_len=32)
                for p in prompts]
        pa.paged_attention.int8_launches = 0
        eng.serve(reqs, timeout=300)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
        st = eng.kv_stats()
        host = {k: st["host"][k] for k in ("entries", "spills", "restores",
                                           "discards")}
        counters[dev] = {"prefix": st["prefix"], "host": host,
                         "restore_failures": eng.stats["restore_failures"],
                         "decode_steps": eng.stats["decode_steps"],
                         "int8_launches": pa.paged_attention.int8_launches}
    equal = outs["cuda"] == outs["cpu"]
    same = all(counters["cuda"][k] == counters["cpu"][k]
               for k in ("prefix", "host", "restore_failures"))
    expected = cfg.num_hidden_layers * counters["cuda"]["decode_steps"]
    emit({"phase": "engine_parity_int8", "equal": equal,
          "counters_equal": same, "counters": counters,
          "expected_int8_launches": expected,
          "tokens": sum(len(o) for o in outs["cuda"])})
    if not equal:
        raise AssertionError(f"int8 engine: card vs CPU greedy tokens "
                             f"differ: {outs['cuda']} vs {outs['cpu']}")
    if not same:
        raise AssertionError(f"int8 engine: card vs CPU counters differ: "
                             f"{counters}")
    host = counters["cuda"]["host"]
    if host["spills"] < 1 or host["restores"] < 1:
        raise AssertionError(f"int8 engine: no spill/restore: {host}")
    if counters["cuda"]["int8_launches"] != expected or expected == 0:
        raise AssertionError(f"int8 kernel launched "
                             f"{counters['cuda']['int8_launches']} times, "
                             f"expected {expected}")
    if counters["cpu"]["int8_launches"] != 0:
        raise AssertionError("the CPU engine launched the int8 kernel")


def flash_launches():
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def reset_flash_launches() -> None:
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def llm_loss(model, ids, labels):
    return model(ids, labels=labels)


def phase_train_parity(pt_pkg):
    """A tiny fp32 Llama (d 64) trained 3 TrainStep steps on the card
    (flash kernels) and on the CPU (plain versions) from the same state and
    the same batch (s 100: a ragged last tile). Losses within 1e-4: f32
    sums in other orders on the two devices. Parameters within 5e-4, half
    of one step's move (lr 1e-3): Adam's ``m / (sqrt(v) + eps)`` turns the
    f32 noise of a gradient near zero into up to ``lr * noise / eps`` of
    parameter (tests/test_torch_train.py measures the same effect against
    JAX); the share of parameters within 1e-5 is reported beside it."""
    import numpy as np
    import torch

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(0).integers(0, 256, (4, 100))
    losses = {}
    before = flash_launches()
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = pt_pkg.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        step = pt_pkg.TrainStep(model, opt, llm_loss, device=dev)
        losses[dev] = [float(step(ids, ids)) for _ in range(3)]
    moved = {k: v - before[k] for k, v in flash_launches().items()}
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_sd = cpu_model.state_dict()
    diffs = torch.cat([(p.detach().cpu() - cpu_sd[n]).abs().flatten()
                       for n, p in gpu_model.state_dict().items()])
    param_err = float(diffs.max())
    emit({"phase": "train_parity", "losses": losses, "loss_err": loss_err,
          "param_err": param_err,
          "params_within_1e-5": float((diffs <= 1e-5).float().mean()),
          "flash_launches": moved})
    if not (loss_err <= 1e-4 and param_err <= 5e-4):
        raise AssertionError(f"card vs CPU training differs: loss {loss_err}, "
                             f"params {param_err}")
    if min(moved.values()) < cfg.num_hidden_layers * 3:
        raise AssertionError(f"flash kernels not launched by the card's "
                             f"train steps: {moved}")


def moe_parity_config(pt_pkg):
    return pt_pkg.MoEConfig(
        vocab_size=256, hidden_size=256, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
        max_position_embeddings=128, dtype="float32", dispatch_mode="fused")


def phase_moe_parity(pt_pkg):
    """A tiny fp32 MoE decoder (fused mode) trained 3 TrainStep steps on the
    card (gather-GEMM and flash kernels) and on the CPU (plain versions)
    from one state and one batch (s 100). The gates are drawn N(0, 0.5) so
    that router logits are far apart: an argmax that f32 noise could flip
    between the two devices would reroute a token, which is no kernel
    fault. Bounds as in train_parity."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg

    cfg = moe_parity_config(pt_pkg)
    cpu_model = pt_pkg.MoEForCausalLM(cfg, device="cpu", seed=1)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(2)
        for layer in cpu_model.layers:
            layer.mlp.gate.weight.normal_(0.0, 0.5, generator=gen)
    gpu_model = pt_pkg.MoEForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(0).integers(0, 256, (4, 100))
    losses = {}
    gg.gather_gemm_ffn.launches = 0
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = pt_pkg.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        step = pt_pkg.TrainStep(model, opt, llm_loss, device=dev)
        losses[dev] = [float(step(ids, ids)) for _ in range(3)]
    moved = gg.gather_gemm_ffn.launches
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_sd = cpu_model.state_dict()
    diffs = torch.cat([(p.detach().cpu() - cpu_sd[n]).abs().flatten()
                       for n, p in gpu_model.state_dict().items()])
    param_err = float(diffs.max())
    emit({"phase": "moe_parity", "losses": losses, "loss_err": loss_err,
          "param_err": param_err,
          "params_within_1e-5": float((diffs <= 1e-5).float().mean()),
          "gather_gemm_launches": moved})
    if not (loss_err <= 1e-4 and param_err <= 5e-4):
        raise AssertionError(f"card vs CPU MoE training differs: loss "
                             f"{loss_err}, params {param_err}")
    if moved != cfg.num_hidden_layers * 3:
        raise AssertionError(f"gather-GEMM launched {moved} times in the "
                             f"card's 3 steps, expected "
                             f"{cfg.num_hidden_layers} x 3")


TRAIN_LAYERS = 8      # Llama-3-8B widths at 8 of 32 layers: AdamW with f32
#                       masters costs 16 bytes a parameter (45 GB here)
TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def train_breakdown(step, ids, step_ms):
    """Device time of one profiled step by kind, and the device's idle share
    against the median unprofiled step. The profiled step counts as a
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, ids)
        torch.cuda.synchronize()
    by_kind = {"matmul": 0.0, "flash": 0.0, "gather_gemm": 0.0, "other": 0.0}
    top = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("flash" if "flash_" in name and "kernel" in name else
                "gather_gemm" if ("gather_gateup" in name
                                  or "expert_down" in name) else
                "matmul" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                    "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + ms
    busy = sum(by_kind.values())
    return {"device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / step_ms if busy > 0
            else "not measured",
            "device_ms_by_kind": by_kind,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                   [:10])}


def phase_train(pt_pkg):
    """The training slice at full width: Llama-3-8B widths, 8 layers, bf16
    with f32 masters, AdamW + global-norm clip, batch 4 x 2048 repeated."""
    import numpy as np
    import torch

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       multi_precision=True,
                       parameters=model.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(model, opt, llm_loss)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    reset_flash_launches()
    losses, wall_ms = [], []
    for _ in range(6):                       # 1 warm-up + 5 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(float(loss))           # syncs
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    timed = sorted(wall_ms[1:])
    step_ms = timed[len(timed) // 2]
    breakdown = train_breakdown(step, ids, step_ms)
    n_steps = len(wall_ms) + 1               # the profiled step included
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated()
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    n = cfg.num_params()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (step_ms / 1e3)
    flops_per_token = 6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size         * TRAIN_SEQ
    emit({"phase": "train", "model": "llama3_8b widths", "layers":
          cfg.num_hidden_layers, "params": n, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "init_s": init_s, "steps": n_steps,
          "step_ms": step_ms, "step_ms_all": wall_ms, "tokens_per_s": tok_s,
          "mfu": tok_s * flops_per_token / BF16_FLOP_PER_S,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "flash_launches": launches,
          "expected_launches": cfg.num_hidden_layers * n_steps,
          "nonfinite_params": bad, "breakdown": breakdown})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if any(v != cfg.num_hidden_layers * n_steps for v in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{cfg.num_hidden_layers} x {n_steps}")
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    return launches


MOE_TRAIN_LAYERS = 4     # DeepSeekMoE-16B widths at 4 of 28 layers: 2.77 B
#                          parameters, 16 bytes each with f32 AdamW masters


def moe_train_config(pt_pkg):
    """DeepSeekMoE-16B's published widths (deepseek-ai/deepseek-moe-16b-base
    config.json) as far as the JAX MoEForCausalLM expresses them; top-2
    (published 6: any k > 1 is GShard top-2 there), 4 layers (published
    28), no leading dense layer, renormalised top-2 gate values."""
    return pt_pkg.MoEConfig(
        vocab_size=102400, hidden_size=MOE_D, intermediate_size=MOE_H,
        num_hidden_layers=MOE_TRAIN_LAYERS, num_attention_heads=16,
        num_key_value_heads=16, num_experts=MOE_E, num_experts_per_tok=2,
        num_shared_experts=2, capacity_factor=1.25,
        max_position_embeddings=4096, rms_norm_eps=1e-6, rope_theta=10000.0,
        aux_loss_weight=0.001, dtype="bfloat16", dispatch_mode="fused")


def moe_drop_shares(model, ids):
    """Share of routed entries each layer's capacity dropped, from one
    forward without gradients (run after the counted steps)."""
    import torch

    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    shares = []

    def hook(mlp, args):
        x = args[0].reshape(-1, mlp.d_model)
        logits = x.float() @ mlp.gate.weight.float()
        soe = tmoe._capacity_slot_maps(logits, mlp.gate.topk, mlp.num_experts,
                                       mlp.capacity(x.shape[0]),
                                       x.shape[0])[2]
        shares.append((soe < 0).float().mean())

    handles = [layer.mlp.register_forward_pre_hook(hook)
               for layer in model.layers]
    with torch.no_grad():
        model(ids)
    for hd in handles:
        hd.remove()
    return [float(s) for s in shares]


def phase_moe_train(pt_pkg):
    """The MoE training slice at full width (see moe_train_config)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg

    cfg = moe_train_config(pt_pkg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.MoEForCausalLM(cfg, device="cuda", seed=0, init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       multi_precision=True,
                       parameters=model.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(model, opt, llm_loss)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    reset_flash_launches()
    gg.gather_gemm_ffn.launches = 0
    gg.gather_gateup.launches = gg.expert_down.launches = 0
    losses, wall_ms = [], []
    for _ in range(6):                       # 1 warm-up + 5 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(float(loss))           # syncs
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    timed = sorted(wall_ms[1:])
    step_ms = timed[len(timed) // 2]
    breakdown = train_breakdown(step, ids, step_ms)
    n_steps = len(wall_ms) + 1               # the profiled step included
    launches = {"gather_gemm_ffn": gg.gather_gemm_ffn.launches,
                "gather_gateup": gg.gather_gateup.launches,
                "expert_down": gg.expert_down.launches, **flash_launches()}
    peak = torch.cuda.max_memory_allocated()
    drops = moe_drop_shares(model, ids)
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    total = sum(p.numel() for p in model.parameters())
    L, h = cfg.num_hidden_layers, cfg.hidden_size
    inactive = L * (cfg.num_experts - cfg.num_experts_per_tok) * 3 * h \
        * cfg.intermediate_size
    active = total - inactive
    flops_per_token = 6 * active + 12 * L * h * TRAIN_SEQ   # bench.py:291-299
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (step_ms / 1e3)
    emit({"phase": "moe_train", "model": "deepseek-moe-16b widths",
          "layers": L, "params": total, "params_active": active,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "capacity": model.layers[0].mlp.capacity(tokens),
          "init_s": init_s, "steps": n_steps, "step_ms": step_ms,
          "step_ms_all": wall_ms, "tokens_per_s": tok_s,
          "mfu_active": tok_s * flops_per_token / BF16_FLOP_PER_S,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "launches": launches, "expected_launches": L * n_steps,
          "drop_share_per_layer": drops, "nonfinite_params": bad,
          "breakdown": breakdown})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train losses not finite and falling: "
                             f"{losses}")
    if any(v != L * n_steps for v in launches.values()):
        raise AssertionError(f"MoE train launches {launches}, expected "
                             f"{L} x {n_steps}")
    if bad:
        raise AssertionError(f"non-finite parameters after MoE training: "
                             f"{bad}")
    return launches["gather_gemm_ffn"]


def decode_breakdown(pt_pkg, eng, prompts):
    """Where one decode chunk's time goes, all slots busy: the host wall of
    an unprofiled chunk, then the device time by kernel from a
    torch.profiler window over the next chunk. Under int8 KV the
    quantize-scatter calls run inside a ``kv_quant_scatter`` range for that
    window, so their kernels' device time (elementwise kernels, counted in
    "other" as well) is read off the range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddlepaddle_tpu_torch.inference import decode_engine as tde

    reqs = [pt_pkg.GenerationRequest(p[:128], 64) for p in prompts[:eng.S]]
    for r in reqs:
        if not eng._admit(r):
            raise AssertionError("breakdown: admission failed")
    eng._decode_chunk()                       # first tokens + a warm chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3
    scatter = tde._kv_quant_scatter

    def ranged(*args):
        with record_function("kv_quant_scatter"):
            return scatter(*args)

    tde._kv_quant_scatter = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._decode_chunk()
            torch.cuda.synchronize()
    finally:
        tde._kv_quant_scatter = scatter
    by_kind = {"paged_attention": 0.0, "paged_attention_int8": 0.0,
               "paged_merge": 0.0, "matmul": 0.0, "other": 0.0}
    top = {}
    quant_ms = 0.0
    for e in prof.key_averages():
        if e.key == "kv_quant_scatter":
            # the CPU range's device time is its kernels'; the range's own
            # span on the device timeline (idle gaps included) is not a
            # kernel and is left out of every sum
            if e.device_type == torch.autograd.DeviceType.CPU:
                quant_ms += e.device_time_total / 1e3
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("paged_attention_int8" if "paged_attn" in name
                and ("signed char" in name or "int8" in name) else
                "paged_attention" if "paged_attn" in name else
                "paged_merge" if "paged_merge" in name else
                "matmul" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                    "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + ms
    while eng.busy_slots():
        eng._decode_chunk()
    busy = sum(by_kind.values())
    out = {"chunk_wall_ms": wall_ms, "steps": eng.chunk,
           "device_busy_ms": busy if busy > 0 else "not measured",
           "device_idle_share": 1 - busy / wall_ms if busy > 0
           else "not measured",
           "device_ms_by_kind": by_kind,
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                  [:8])}
    if eng.kv_quant == "int8":
        out["kv_quant_scatter_device_ms"] = (quant_ms if quant_ms > 0
                                             else "not measured")
    return out


def phase_serve(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    n_req = 24
    plens = rng.integers(64, 1537, n_req)
    budgets = rng.integers(32, 129, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in plens]
    sampled = {5, 17}                       # temperature 0.8, top_k 50
    failures = []
    with pt_pkg.ServingEngine(model, max_batch_size=8, kv_page_size=64,
                              max_len=2048, decode_chunk=16,
                              device="cuda") as se:
        eng = se.engine
        # one short warm-up request (cuBLAS handles, allocator) before the
        # counted run
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        pa.paged_attention.launches = 0
        steps0 = eng.stats["decode_steps"]
        chunks0 = len(eng.chunk_ms)
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b),
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = []
        for i, f in enumerate(futs):
            try:
                outs.append(f.result(900))
            except Exception as e:  # noqa: BLE001 — counted and reported
                failures.append(f"request {i}: {type(e).__name__}: {e}")
                outs.append(None)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = eng.stats["decode_steps"] - steps0
        chunk_ms = sorted(eng.chunk_ms[chunks0:])
        peak = torch.cuda.max_memory_allocated()
        # the decode path (paged kernel) against a plain causal forward on
        # the shortest greedy request: every emitted token within bf16 noise
        # of the reference argmax logit. The reference is the prefill's own
        # attention (``_cached_attention`` over a scratch cache at position
        # 0), so the prompt rows match the engine's bit for bit. The
        # cache-less flash forward is another bf16 order of the same 32
        # layers: as the reference here it read gaps of 0.25 and 0.22 on
        # these random weights (PERF.md), so it is checked by the
        # flash_kernel and train phases instead
        greedy = [i for i in range(n_req) if i not in sampled
                  and outs[i] is not None]
        i_chk = min(greedy, key=lambda i: plens[i])
        seq = torch.as_tensor(outs[i_chk][:-1].astype(np.int64),
                              device="cuda")[None]
        shape = (1, seq.shape[1], cfg.num_key_value_heads, cfg.head_dim)
        with torch.no_grad():
            scratch = [(torch.zeros(shape, dtype=model.dtype, device="cuda"),
                        torch.zeros(shape, dtype=model.dtype, device="cuda"))
                       for _ in range(cfg.num_hidden_layers)]
            hidden, _ = model.model(seq, caches=scratch, pos=0)
            del scratch
            lg = model.logits(hidden)[0, int(plens[i_chk]) - 1:].float()
        emitted = torch.as_tensor(outs[i_chk][int(plens[i_chk]):]
                                  .astype(np.int64), device="cuda")
        gap = float((lg.max(-1).values
                     - lg.gather(1, emitted[:, None])[:, 0]).max())
    breakdown = decode_breakdown(pt_pkg, eng, prompts)
    bad_len = [i for i, o in enumerate(outs) if o is not None
               and len(o) != plens[i] + budgets[i]]
    bad_tok = [i for i, o in enumerate(outs) if o is not None
               and not ((o >= 0) & (o < cfg.vocab_size)).all()]
    new_tokens = int(sum(len(o) - plens[i] for i, o in enumerate(outs)
                         if o is not None))
    slo = pt_pkg.slo_summary([f for f, o in zip(futs, outs) if o is not None])
    emit({"phase": "serve", "model": "llama3_8b", "params": cfg.num_params(),
          "init_s": init_s, "requests": n_req,
          "completed": sum(o is not None for o in outs),
          "failed": len(failures), "new_tokens": new_tokens, "wall_s": wall,
          "tok_s": new_tokens / wall, "ttft_p50_ms": slo["ttft_p50_ms"],
          "ttft_p99_ms": slo["ttft_p99_ms"], "tpot_ms": slo["tpot_ms"],
          "decode_steps": steps, "decode_chunks": len(chunk_ms),
          "decode_chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms
          else None,
          "decode_chunk_ms_max": chunk_ms[-1] if chunk_ms else None,
          "paged_attention_launches": launches,
          "expected_launches": cfg.num_hidden_layers * steps,
          "peak_mem_gb": peak / 1e9, "greedy_check_logit_gap": gap,
          "decode_breakdown": breakdown})
    if failures:
        raise AssertionError("requests failed: " + "; ".join(failures))
    if bad_len or bad_tok:
        raise AssertionError(f"wrong output length {bad_len} / out-of-vocab "
                             f"tokens {bad_tok}")
    if steps == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected {cfg.num_hidden_layers} x {steps}")
    if not gap <= 0.25:
        raise AssertionError(f"decode path disagrees with the plain forward: "
                             f"an emitted token's logit is {gap} below the "
                             "argmax")
    return launches


SERVE_INT8 = dict(max_batch_size=8, kv_page_size=64, max_len=2048,
                  decode_chunk=16, kv_quant="int8", kv_host_bytes=256 << 20)
SYSTEM_LEN, N_SYSTEMS, SERVE_INT8_REQUESTS = 1024, 4, 32


def serve_int8_workload(vocab: int):
    """Chat serving with a few system prompts whose working set exceeds the
    device pool: four 1024-token system prompts (numpy seed 0), 32 requests
    round-robin over them, each its system prompt plus a 64-512-token tail,
    budgets 32-128. Returns (prompts, budgets, the page count that holds
    the private pages of the first 8 requests, as prefix hits, beside two
    of the four 16-page prefixes: the four prefixes do not fit beside a
    full batch, so refcount-0 prefixes spill to the host tier and come
    back)."""
    import numpy as np

    rng = np.random.default_rng(0)
    systems = [rng.integers(0, vocab, (SYSTEM_LEN,)) for _ in range(N_SYSTEMS)]
    tails = rng.integers(64, 513, SERVE_INT8_REQUESTS)
    budgets = rng.integers(32, 129, SERVE_INT8_REQUESTS)
    prompts = [np.concatenate([systems[i % N_SYSTEMS],
                               rng.integers(0, vocab, (int(t),))])
               for i, t in enumerate(tails)]
    ps = SERVE_INT8["kv_page_size"]
    n_pfx = SYSTEM_LEN // ps
    private = sum(-(-(SYSTEM_LEN + int(t) + int(b)) // ps) - n_pfx
                  for t, b in list(zip(tails, budgets))[
                      :SERVE_INT8["max_batch_size"]])
    return prompts, budgets, 1 + private + 2 * n_pfx


def phase_serve_int8(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, budgets, num_pages = serve_int8_workload(cfg.vocab_size)
    plens = [len(p) for p in prompts]
    sampled = {5, 17}                       # temperature 0.8, top_k 50
    failures = []
    with pt_pkg.ServingEngine(model, kv_num_pages=num_pages, device="cuda",
                              **SERVE_INT8) as se:
        eng = se.engine
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)  # warm
        pa.paged_attention.int8_launches = 0
        steps0 = eng.stats["decode_steps"]
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b), prefix_len=SYSTEM_LEN,
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = []
        for i, f in enumerate(futs):
            try:
                outs.append(f.result(900))
            except Exception as e:  # noqa: BLE001 — counted and reported
                failures.append(f"request {i}: {type(e).__name__}: {e}")
                outs.append(None)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.int8_launches
        steps = eng.stats["decode_steps"] - steps0
        kv = eng.kv_stats()
        restore_failures = eng.stats["restore_failures"]
        peak = torch.cuda.max_memory_allocated()
    breakdown = decode_breakdown(pt_pkg, eng, prompts)
    bf16_page = (kv["page_size"] * 2 * cfg.num_key_value_heads * cfg.head_dim
                 * 2 * cfg.num_hidden_layers)
    bad_len = [i for i, o in enumerate(outs) if o is not None
               and len(o) != plens[i] + budgets[i]]
    bad_tok = [i for i, o in enumerate(outs) if o is not None
               and not ((o >= 0) & (o < cfg.vocab_size)).all()]
    new_tokens = int(sum(len(o) - plens[i] for i, o in enumerate(outs)
                         if o is not None))
    slo = pt_pkg.slo_summary([f for f, o in zip(futs, outs) if o is not None])
    host = kv["host"]
    emit({"phase": "serve_int8", "model": "llama3_8b", "init_s": init_s,
          "engine": dict(SERVE_INT8, kv_num_pages=num_pages),
          "requests": len(prompts), "completed": sum(o is not None
                                                      for o in outs),
          "failed": len(failures), "new_tokens": new_tokens, "wall_s": wall,
          "tok_s": new_tokens / wall, "ttft_p50_ms": slo["ttft_p50_ms"],
          "ttft_p99_ms": slo["ttft_p99_ms"], "tpot_ms": slo["tpot_ms"],
          "decode_steps": steps, "int8_launches": launches,
          "expected_int8_launches": cfg.num_hidden_layers * steps,
          "prefix": kv["prefix"], "host": host,
          "restore_failures": restore_failures,
          "page_bytes": kv["page_bytes"], "kv_bytes": kv["kv_bytes"],
          "bf16_page_bytes": bf16_page,
          "bf16_kv_bytes": bf16_page * (kv["pages_total"] + 1),
          "peak_mem_gb": peak / 1e9, "decode_breakdown": breakdown})
    if failures:
        raise AssertionError("requests failed: " + "; ".join(failures))
    if bad_len or bad_tok:
        raise AssertionError(f"wrong output length {bad_len} / out-of-vocab "
                             f"tokens {bad_tok}")
    if host["spills"] < 1 or host["restores"] < 1:
        raise AssertionError(f"serve_int8: no spill/restore: {host}")
    if steps == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"paged_attention int8 launched {launches} "
                             f"times, expected {cfg.num_hidden_layers} x "
                             f"{steps}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script checks the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    import paddlepaddle_tpu_torch as pt_pkg
    from paddlepaddle_tpu_torch.ops.kernels import _build

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "tf32": False})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {n: {"seconds": b["seconds"], "cached": b["cached"],
                          "ptxas": [ln.strip() for ln in
                                    str(b["ptxas"]).splitlines()
                                    if "Used" in ln or "spill" in ln][:48]}
                      for n, b in built.items()}})

    record = phase_kernel()
    int8_record = phase_kernel_int8()
    flash_records = phase_flash_kernel()
    varlen_records = phase_flash_varlen_kernel()
    gc.collect()                    # free the full-width varlen buffers
    torch.cuda.empty_cache()
    gg_record = phase_gather_gemm_kernel()
    phase_engine_parity(pt_pkg)
    phase_engine_parity_int8(pt_pkg)
    phase_train_parity(pt_pkg)
    phase_moe_parity(pt_pkg)
    record["launches"] = phase_serve(pt_pkg)
    gc.collect()                    # free the serving model
    torch.cuda.empty_cache()
    int8_record["launches"] = phase_serve_int8(pt_pkg)
    gc.collect()                    # free the int8 serving model
    torch.cuda.empty_cache()
    launches = phase_train(pt_pkg)
    for r in flash_records:
        r["launches"] = launches[r["name"]]
    gc.collect()                    # free the Llama training model
    torch.cuda.empty_cache()
    gg_record["launches"] = phase_moe_train(pt_pkg)
    emit({"kernels": [record, int8_record] + flash_records + varlen_records
          + [gg_record]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
