#!/usr/bin/env python3
"""Time variants of the bf16 packed varlen forward and dK/dV kernels side by
side on one card.

Each variant is ``paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu``
with some of its text replaced (a stage count, an order of the tiles), built
by its own ``nvcc`` into the git-ignored kernel build directory, checked at
the packed batch of ``chip_smoke.py``'s ``flash_varlen_kernel`` phase (t 8256:
8192 tokens in causal segments of 64-2048, one empty, a 64-row tail; h 32,
d 128, bf16) against the plain versions (2e-2 + 1e-2 |x|), and timed
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
``flash_varlen.cu`` whose forward and dK/dV entries still take bf16
(``git show <commit>:paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen.cu``
of a tree before those kernels moved to ``flash_varlen_sm90.cu``), timed in
the same rounds.
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
    _, dk_p, dv_p = fv.varlen_bwd_plain(q, k, v, do, lse_p, delta, cu, cu,
                                        True, scale)
    want = {"out": out_p, "lse": lse_p, "dk": dk_p, "dv": dv_p}
    row_ok = fv.varlen_mask(cu, cu, t, t, True).any(1)
    out, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    lse = torch.empty_like(lse_p)
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = (cu.data_ptr(), cu.data_ptr(), len(lens), h, t, t, d, scale, 1)
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        old = name == "old"
        f_fwd = lib.varlen_fwd_launch if old else lib.varlen_fwd_sm90_launch
        f_dkv = (lib.varlen_bwd_dkv_launch if old
                 else lib.varlen_bwd_dkv_sm90_launch)
        shape = [vp, vp] + [ci] * 5 + [cf, ci] + [ci] * old + [vp]
        f_fwd.argtypes = [vp] * 5 + shape
        f_dkv.argtypes = [vp] * 8 + shape
        flags = (1,) if old else ()          # is_bf16

        def c_fwd(f=f_fwd, flags=flags):
            return f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), *tail, *flags, stream)

        def c_dkv(f=f_dkv, flags=flags):
            return f(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse_p.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *tail, *flags, stream)

        if c_fwd() or c_dkv():
            raise SystemExit(f"{name}: launch failed")
        torch.cuda.synchronize()
        got = {"out": out, "lse": lse, "dk": dk, "dv": dv}
        errs, excess = {}, {}
        for key, w in want.items():
            a, b = got[key].float(), w.float()
            if key == "lse":
                a, b = a[:, row_ok], b[:, row_ok]
            diff = (a - b).abs()
            errs[key] = float(diff.max())
            excess[key] = float((diff - 2e-2 - 1e-2 * b.abs()).max())
        print(json.dumps({"variant": name, "max_abs_err": errs,
                          "max_excess": excess,
                          "checked": name not in time_only}), flush=True)
        if name not in time_only and max(excess.values()) > 0:
            raise SystemExit(f"{name}: error {errs} beyond 2e-2 + 1e-2 |x|")
        calls[name] = (c_fwd, c_dkv)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    names = list(calls)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            c_fwd, c_dkv = calls[name]
            print(json.dumps({"round": rnd, "variant": name,
                              "fwd_ms": cs.median_ms(c_fwd, flush=flush),
                              "dkv_ms": cs.median_ms(c_dkv, flush=flush)}),
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
