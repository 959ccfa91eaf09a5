#!/usr/bin/env python3
"""Count the paged kernels that torch.profiler sees in speculative chunks,
against the launch counter, window by window, on one card.

The setup is ``chip_smoke.py``'s ``serve_spec`` self-draft run: the serve
phase's Llama-3-8B (32 layers, bf16, seeded), ``ServingEngine(
max_batch_size=8, kv_page_size=64, max_len=2048, decode_chunk=16,
draft=model, spec_k=3)`` with the verify check's tap, 8 of serve's greedy
prompts at budget 64. Then, twice: 8 admissions of their first 128 tokens
(budget 400), two chunks, and 4 chunks each under its own torch.profiler
window. Each window prints the counter's move, the ``paged_attn_kernel`` /
``paged_merge_kernel`` counts from ``key_averages()``, the paged kernels
grouped by the graph launch they belong to, and the window's device record
count. A replay holds a fixed set of kernels, so a window that shows fewer
than the counter (with fewer device records than its neighbours) is one in
which the profiler lost records. Run from the repository root on a machine
with an H100:

    python3 tools/spec_profile_windows.py
"""
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ctx = cs.phase_serve(pt)
    model = ctx["model"]
    chosen = sorted(ctx["greedy_outs"])[:8]
    prompts = [ctx["prompts"][i] for i in chosen]
    with pt.ServingEngine(model, max_batch_size=8, kv_page_size=64,
                          max_len=2048, decode_chunk=16, draft=model,
                          spec_k=3, device="cuda") as se:
        eng = se.engine
        check = cs.verify_tap(eng)
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        futs = [se.submit(p, max_new_tokens=64) for p in prompts]
        for f in futs:
            f.result(900)
        while eng.busy_slots():
            time.sleep(0.01)
    for rnd in range(2):
        for p in prompts:
            eng._admit(pt.GenerationRequest(p[:128], 400))
        eng._decode_chunk()
        check(eng)
        eng._decode_chunk()
        for w in range(4):
            before = pa.paged_attention.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng._decode_chunk()
                torch.cuda.synchronize()
            moved = pa.paged_attention.launches - before
            ka = {"attn": 0, "merge": 0}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                if "paged_attn_kernel" in e.key.lower():
                    ka["attn"] += e.count
                if "paged_merge_kernel" in e.key.lower():
                    ka["merge"] += e.count
            per_launch = collections.Counter()
            n_dev = 0
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                n_dev += 1
                if "paged_attn_kernel" in e.name.lower():
                    per_launch[e.id] += 1
            print(json.dumps({"round": rnd, "window": w, "moved": moved,
                              "key_averages": ka,
                              "events_attn": sum(per_launch.values()),
                              "device_events": n_dev,
                              "per_launch": sorted(per_launch.values())}),
                  flush=True)
        while eng.busy_slots():
            eng._decode_chunk()
    print("leaked", cs.leaked_pages(eng))
    return 0


if __name__ == "__main__":
    sys.exit(main())
