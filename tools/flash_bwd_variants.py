#!/usr/bin/env python3
"""Time variants of the bf16 flash backward kernels side by side on one card.

Each variant is ``paddlepaddle_tpu_torch/ops/kernels/csrc/flash_bwd_sm90.cu``
with some of its text replaced (a tile width, a stage count), built by its
own ``nvcc`` into the git-ignored kernel build directory, checked at the
train phase's shape (b 4, s 2048, h 32, d 128, bf16, causal) against
autograd of the plain forward, and timed (CUDA-event medians, L2 flushed,
as ``chip_smoke.median_ms``) in two rounds, the second in reverse order.
Run from the repository root on a machine with an H100:

    python3 tools/flash_bwd_variants.py '{"base": {}, "dq128":
        {"constexpr int kDqBN = 64;": "constexpr int kDqBN = 128;"}}' \\
        [--old OLD_flash_attention.cu]

A variant given as a string instead of a mapping is the path of a whole
source with the same C entries (another design of the same kernels).
``--old`` adds an older ``flash_attention.cu`` whose C entries still take
bf16 (``git show <commit>:paddlepaddle_tpu_torch/ops/kernels/csrc/flash_attention.cu``
of a tree before the bf16 backward moved to ``flash_bwd_sm90.cu``), timed
in the same rounds.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddlepaddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402


def build(sources):
    """name -> source path; returns name -> shared library path."""
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"{name}.so"
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
    ap.add_argument("--old", help="an older flash_attention.cu (bf16 entries)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    src = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
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
        sources[name] = out_dir / f"{name}.cu"
        sources[name].write_text(text)
    if args.old:
        sources["old"] = Path(args.old).resolve()
    libs = build(sources)

    b, s, h, d = 4, 2048, 32, 128
    scale = d ** -0.5
    q, k, v, do = cs.flash_inputs(np.random.default_rng(0), b, s, s, h, d,
                                  torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(out, do)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out_p, _ = fa.flash_attention_plain(qr, kr, vr, True, scale)
    want = torch.autograd.grad(out_p, (qr, kr, vr), do)
    del out_p, qr, kr, vr
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        old = name == "old"
        f_dq = lib.flash_bwd_dq_launch if old else lib.flash_bwd_dq_sm90_launch
        f_dkv = (lib.flash_bwd_dkv_launch if old
                 else lib.flash_bwd_dkv_sm90_launch)
        tail = [cf, ci, ci, vp] if old else [cf, ci, vp]
        f_dq.argtypes = [vp] * 7 + [ci] * 5 + tail
        f_dkv.argtypes = [vp] * 8 + [ci] * 5 + tail
        flags = (1, 1) if old else (1,)          # causal (, is_bf16)

        def c_dq(f=f_dq, flags=flags):
            return f(*ptrs, dq.data_ptr(), b, h, s, s, d, scale, *flags,
                     stream)

        def c_dkv(f=f_dkv, flags=flags):
            return f(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, s, s, d,
                     scale, *flags, stream)

        if c_dq() or c_dkv():
            raise SystemExit(f"{name}: launch failed")
        torch.cuda.synchronize()
        # bf16 outputs: 2e-2 absolute plus one bf16 ulp (2^-8 relative) for
        # gradients of magnitude 4 and more, where one ulp is 2^-5
        errs = [float((a.float() - w.float()).abs().max())
                for a, w in zip((dq, dk, dv), want)]
        excess = [float(((a.float() - w.float()).abs()
                         - 2e-2 - w.float().abs() / 128).max())
                  for a, w in zip((dq, dk, dv), want)]
        print(json.dumps({"variant": name, "max_abs_err": errs,
                          "max_excess": excess}), flush=True)
        if max(excess) > 0:
            raise SystemExit(f"{name}: error {errs} beyond 2e-2 + |x|/128")
        calls[name] = (c_dq, c_dkv)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    names = list(calls)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            c_dq, c_dkv = calls[name]
            print(json.dumps({"round": rnd, "variant": name,
                              "dq_ms": cs.median_ms(c_dq, flush=flush),
                              "dkv_ms": cs.median_ms(c_dkv, flush=flush)}),
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
