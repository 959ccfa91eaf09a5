#!/usr/bin/env python3
"""Time variants of the bf16 gather-GEMM kernels side by side on one card.

Each variant is ``paddlepaddle_tpu_torch/ops/kernels/csrc/gather_gemm_sm90.cu``
with some of its text replaced (a tile width, a stage count), built by its
own ``nvcc`` into the git-ignored kernel build directory, checked at the
moe_train shape (E 64, C 320, T 8192, d 2048, h 1408, bf16, slots from a
routing of random x) phase by phase against the plain halves, and timed
(CUDA-event medians, L2 flushed, as ``chip_smoke.median_ms``) in two rounds,
the second in reverse order: gather_gateup, expert_down and the two in a
row. Run from the repository root on a machine with an H100:

    python3 tools/gather_gemm_variants.py '{"base": {}, "st3":
        {"kGateUpStages = 4;": "kGateUpStages = 3;"}}' [--old OLD.cu]

A variant given as a string instead of a mapping is the path of a whole
source with the same C entries (another design of the same kernels).
``--time-only NAME,...`` skips the check of the named variants: for
variants that drop work on purpose, to find what limits the kernel.
``--old`` adds an older ``gather_gemm.cu`` whose C entry is the fused
one-launch ``gather_gemm_launch`` (``git show <commit>:paddlepaddle_tpu_torch/
ops/kernels/csrc/gather_gemm.cu`` of a tree before the split), timed as a
whole call in the same rounds.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddlepaddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg  # noqa: E402
from paddlepaddle_tpu_torch.parallel import moe as tmoe  # noqa: E402


def build(sources):
    """name -> source path; returns name -> shared library path."""
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"gg_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        keep = [ln.strip() for ln in log.splitlines()
                if any(w in ln for w in ("Used", "spill", "arning", "rror",
                                           "Performance"))]
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode,
                          "ptxas": keep}), flush=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", help="JSON: name -> {old text: new text}")
    ap.add_argument("--old", help="an older gather_gemm.cu (fused entry)")
    ap.add_argument("--time-only", default="",
                    help="comma-separated variants timed without a check")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    src = (_build.CSRC / "gather_gemm_sm90.cu").read_text()
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, subs in json.loads(args.variants).items():
        if isinstance(subs, str):            # a whole source of its own
            sources[name] = Path(subs).resolve()
            continue
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        sources[name] = out_dir / f"gg_{name}.cu"
        sources[name].write_text(text)
    if args.old:
        sources["old"] = Path(args.old).resolve()
    libs = build(sources)

    T, E, C, d, h = cs.MOE_T, cs.MOE_E, cs.MOE_C, cs.MOE_D, cs.MOE_H
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(T, d, device="cuda", generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(E, d, h, device="cuda", generator=gen).mul_(0.02)
              .to(torch.bfloat16) for _ in range(2))
    wd = torch.randn(E, h, d, device="cuda", generator=gen).mul_(0.02) \
        .to(torch.bfloat16)
    gate_w = torch.randn(d, E, device="cuda", generator=gen).mul_(0.02)
    _, _, _, valid, entry = tmoe._capacity_slot_maps(x.float() @ gate_w, 2,
                                                     E, C, T)
    slot = torch.where(valid, entry % T, T).to(torch.int32)
    hmid_want = gg.gather_gateup_plain(x, slot, wg, wu, capacity=C)
    down_want = gg.expert_down_plain(hmid_want, slot, wd, n_tokens=T)
    call_want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    hmid = torch.empty_like(hmid_want)
    out = torch.empty_like(down_want)
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci = ctypes.c_void_p, ctypes.c_int
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if name == "old":
            f = lib.gather_gemm_launch
            f.argtypes = [vp] * 6 + [ci] * 6 + [vp]

            def c_call(f=f):
                return f(x.data_ptr(), slot.data_ptr(), wg.data_ptr(),
                         wu.data_ptr(), wd.data_ptr(), out.data_ptr(), T, E,
                         C, d, h, 1, stream)

            if c_call():
                raise SystemExit("old: launch failed")
            torch.cuda.synchronize()
            err = (out.float() - call_want.float()).abs()
            bound = gg.bf16_error_bound(x, slot, wg, wu, wd, capacity=C,
                                        plain=call_want)
            ratio = float((err / bound).max())
            print(json.dumps({"variant": name, "call_err_over_allowed":
                              ratio}), flush=True)
            if ratio > 1:
                raise SystemExit("old: beyond its bound")
            calls[name] = {"call": c_call}
            continue
        fa, fb = lib.gather_gateup_sm90_launch, lib.expert_down_sm90_launch
        fa.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        fb.argtypes = [vp] * 4 + [ci] * 5 + [vp]

        def c_a(f=fa):
            return f(x.data_ptr(), slot.data_ptr(), wg.data_ptr(),
                     wu.data_ptr(), hmid.data_ptr(), T, E, C, d, h, stream)

        def c_b(f=fb, src=hmid):
            return f(src.data_ptr(), slot.data_ptr(), wd.data_ptr(),
                     out.data_ptr(), T, E, C, d, h, stream)

        def c_call(a=c_a, b=c_b):
            return a() or b()

        ratios = {}
        if c_a():
            raise SystemExit(f"{name}: gather_gateup launch failed")
        torch.cuda.synchronize()
        ratios["gather_gateup"] = float(
            ((hmid.float() - hmid_want.float()).abs()
             / gg.gather_gateup_bf16_bound(x, slot, wg, wu, capacity=C,
                                           plain=hmid_want)).max())
        if c_b(src=hmid_want):
            raise SystemExit(f"{name}: expert_down launch failed")
        torch.cuda.synchronize()
        ratios["expert_down"] = float(
            ((out.float() - down_want.float()).abs()
             / gg.expert_down_bf16_bound(hmid_want, wd,
                                         plain=down_want)).max())
        print(json.dumps({"variant": name, "err_over_allowed": ratios}),
              flush=True)
        if max(ratios.values()) > 1 and name not in args.time_only.split(","):
            raise SystemExit(f"{name}: beyond the bound")
        calls[name] = {"gather_gateup": c_a, "expert_down": c_b,
                       "call": c_call}

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    names = list(calls)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            print(json.dumps({"round": rnd, "variant": name, **{
                f"{k}_ms": cs.median_ms(c, flush=flush)
                for k, c in calls[name].items()}}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
