"""Run ``chip_smoke.py``'s tensor-, data- and expert-parallel phases alone
on the card, after building the paged, flash and gather-GEMM kernel
libraries: a quick check of the single-process engine
(``ServingEngine(model, mesh="mp2")`` in this process) and train step
(``ShardedTrainStep`` over a plan in this process) without the whole
script.

    python3 tools/tp_phases_check.py [phase ...]

Phases: ``tp_spec`` (tp_parity's spec-under-mp2 check beside a
one-process engine), ``tp_parity``, ``serve_tp`` (its SPMD arm, then its
single-process arm), ``spec_tp``, ``router_tp``, ``train_tp`` (its SPMD
arms, then its single-process arms), ``nccl_world1``, ``ep_parity``,
``train_ep``, ``fsdp_parity``, ``train_fsdp``, ``pp_parity``,
``train_pp``, ``sp_parity``, ``train_cp``; default ``tp_spec
serve_tp spec_tp router_tp``. Each
phase prints its JSON lines and its seconds; a failed phase prints its
error and the script goes on to the next, exiting 1 at the end.
"""

import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

DEFAULT = ("tp_spec", "serve_tp", "spec_tp", "router_tp")
JOBS = {"train_tp": (cs._train_tp_rank, (cs.TRAIN_TP_SPECS,), 2),
        "nccl_world1": (cs._nccl_world1_rank, (), 1)}


def _tp_spec(pt) -> None:
    import numpy as np

    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cs.TP_TINY["vocab_size"], (int(k),))
               .astype(np.int32) for k in (40, 129, 77, 200)]
    spec = cs._tp_spec_single(pt, prompts, 24)
    one = pt.BatchDecodeEngine(
        pt.LlamaForCausalLM(pt.LlamaConfig(**cs.TP_TINY), seed=0),
        max_slots=4, chunk=8, page_size=64, max_len=512)
    reqs = cs._tp_requests(prompts, [24] * len(prompts))
    one.serve(reqs, timeout=600)
    cs.emit({"phase": "tp_spec",
             "equal_one_process": spec["tokens"] == [
                 r.result.result(5).tolist() for r in reqs],
             "counters": spec["counters"], "gone": spec["gone"],
             "acceptance": spec["acceptance"]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"phase": "env", "torch": torch.__version__,
             "nvidia_smi": cs.nvidia_smi_line()})
    t0 = time.perf_counter()
    _build.build_all(["paged_attention", "flash_attention", "flash_fwd_sm90",
                      "flash_bwd_sm90", "gather_gemm", "gather_gemm_sm90"])
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    failed = []
    for name in sys.argv[1:] or DEFAULT:
        t1 = time.perf_counter()
        try:
            if name == "tp_spec":
                _tp_spec(pt)
            elif name in JOBS:
                # its ranks, which chip_smoke.py starts beside other phases
                fn, args, n = JOBS[name]
                getattr(cs, f"phase_{name}")(pt, cs._spawn_beside(fn, args,
                                                                  n))
            else:
                getattr(cs, f"phase_{name}")(pt)
        except Exception as e:  # noqa: BLE001 — reported, next phase runs
            failed.append(name)
            cs.emit({"phase": f"{name}_failed",
                     "error": f"{type(e).__name__}: {str(e)[:3000]}"})
        cs.emit({"phase": f"{name}_seconds",
                 "seconds": time.perf_counter() - t1})
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
