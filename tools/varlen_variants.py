#!/usr/bin/env python3
"""Time variants of the bf16 packed varlen forward, dQ and dK/dV kernels side
by side on one card.

Each variant is ``paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu``
with some of its text replaced (a stage count, an order of the tiles), built
by its own ``nvcc`` into the git-ignored kernel build directory, checked at
the packed batch of ``chip_smoke.py``'s ``flash_varlen_kernel`` phase (t 8256:
8192 tokens in causal segments of 64-2048, one empty, a 64-row tail; h 32,
d 128, bf16) against the plain versions (2e-2 + 1e-2 |x|; rows that see no
key have out and dQ exactly 0), and timed
(CUDA-event medians, L2 flushed, as ``chip_smoke.median_ms``) in two rounds,
the second in reverse order. Run from the repository root on a machine with
an H100:

    python3 tools/varlen_variants.py '{"base": {}, "fwd2":
        {"constexpr int kFwdStages = 3;": "constexpr int kFwdStages = 2;"}}' \\
        [--old OLD_flash_varlen.cu] [--time-only NAME,...]

A variant given as a string instead of a mapping is the path of a whole
source with the same C entries (another design of the same kernels).
``--time-only`` skips the check of the named variants: for variants that
drop work on purpose, to find what limits a kernel. ``--old`` adds an older
``flash_varlen.cu`` whose entries took bf16 before the kernels moved to
``flash_varlen_sm90.cu`` (the dQ up to the tree that added
``varlen_bwd_dq_sm90_kernel``, the forward and dK/dV before that). Give it
inside that tree's own ``csrc`` directory, so that its includes find that
tree's headers first:

    git archive <commit> paddlepaddle_tpu_torch/ops/kernels/csrc \\
        | tar -x -C _archive/old
    ... --old _archive/old/paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen.cu

Its kernels that still take bf16 are checked and timed in the same rounds;
a kernel whose entry refuses bf16 is left out.
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
from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv  # noqa: E402


def build(sources):
    """name -> source path; returns name -> shared library path."""
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"vl_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode,
                          "ptxas": cs.ptxas_kernels(log)}), flush=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", help="JSON: name -> {old text: new text}")
    ap.add_argument("--old", help="an older flash_varlen.cu (bf16 entries)")
    ap.add_argument("--time-only", default="",
                    help="comma-separated variants timed without the check")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    time_only = set(filter(None, args.time_only.split(",")))
    src = (_build.CSRC / "flash_varlen_sm90.cu").read_text()
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
        sources[name] = out_dir / f"vl_{name}.cu"
        sources[name].write_text(text)
    if args.old:
        sources["old"] = Path(args.old).resolve()
    libs = build(sources)

    # the packed batch (a) of chip_smoke.py's flash_varlen_kernel phase
    h, d = 32, 128
    lens = cs.packed_batch(np.random.default_rng(0), 8192, 64, 2048)
    lens.insert(len(lens) // 2, 0)
    cu_np = cs.varlen_cu(lens)
    t = int(cu_np[-1]) + 64
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (t, h, d), dtype=np.float32)).to("cuda", torch.bfloat16)
        for _ in range(4))
    cu = torch.from_numpy(cu_np).cuda()
    scale = d ** -0.5
    out_p, lse_p = fv.varlen_attention_plain(q, k, v, cu, cu, True, scale)
    delta = fv.varlen_delta(out_p, do)
    dq_p, dk_p, dv_p = fv.varlen_bwd_plain(q, k, v, do, lse_p, delta, cu, cu,
                                           True, scale)
    want = {"fwd": {"out": out_p, "lse": lse_p}, "dq": {"dq": dq_p},
            "dkv": {"dk": dk_p, "dv": dv_p}}
    row_ok = fv.varlen_mask(cu, cu, t, t, True).any(1)
    out, dq, dk, dv = (torch.empty_like(x) for x in (q, q, k, v))
    lse = torch.empty_like(lse_p)
    got = {"fwd": {"out": out, "lse": lse}, "dq": {"dq": dq},
           "dkv": {"dk": dk, "dv": dv}}
    ptrs = {"fwd": (q, k, v, out, lse),
            "dq": (q, k, v, do, lse_p, delta, dq),
            "dkv": (q, k, v, do, lse_p, delta, dk, dv)}
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = (cu.data_ptr(), cu.data_ptr(), len(lens), h, t, t, d, scale, 1)
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        old = name == "old"
        shape = [vp, vp] + [ci] * 5 + [cf, ci] + [ci] * old + [vp]
        flags = (1,) if old else ()          # is_bf16
        calls[name] = {}
        for kind, tensors in ptrs.items():
            entry = {"fwd": "varlen_fwd", "dq": "varlen_bwd_dq",
                     "dkv": "varlen_bwd_dkv"}[kind]
            f = getattr(lib, f"{entry}_launch" if old
                        else f"{entry}_sm90_launch")
            f.argtypes = [vp] * len(tensors) + shape

            def call(f=f, tensors=tensors, flags=flags):
                return f(*(x.data_ptr() for x in tensors), *tail, *flags,
                         stream)

            for x in got[kind].values():
                x.fill_(float("nan"))
            if call():
                if old:                      # this entry refuses bf16
                    continue
                raise SystemExit(f"{name} {kind}: launch failed")
            torch.cuda.synchronize()
            errs, excess = {}, {}
            for key, w in want[kind].items():
                a, b = got[kind][key].float(), w.float()
                if key == "lse":
                    a, b = a[:, row_ok], b[:, row_ok]
                diff = (a - b).abs()
                errs[key] = float(diff.max())
                excess[key] = float((diff - 2e-2 - 1e-2 * b.abs()).max())
            zero = all(bool((got[kind][key][~row_ok] == 0).all())
                       for key in ("out", "dq") if key in got[kind])
            print(json.dumps({"variant": name, "kernel": kind,
                              "max_abs_err": errs, "max_excess": excess,
                              "keyless_rows_zero": zero,
                              "checked": name not in time_only}), flush=True)
            if name not in time_only and (max(excess.values()) > 0
                                          or not zero):
                raise SystemExit(f"{name} {kind}: error {errs} beyond 2e-2 "
                                 f"+ 1e-2 |x|, or keyless rows not 0")
            calls[name][kind] = call

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    names = list(calls)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            print(json.dumps({"round": rnd, "variant": name, **{
                f"{kind}_ms": cs.median_ms(call, flush=flush)
                for kind, call in calls[name].items()}}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
