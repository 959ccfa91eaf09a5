"""Build every kernel library and run the flash-attention kernel phases of
``chip_smoke.py`` on the card: bf16/f32 (``phase_flash_kernel``), fp16
(``phase_flash_fp16``), and the varlen and gather-GEMM phases that share
``csrc/hopper.cuh``. A quick check after a change to the sm90 flash
kernels or the shared header:

    python3 tools/flash_fp16_check.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from paddlepaddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    chip_smoke.emit({"phase": "build", "seconds": time.perf_counter() - t0,
                     "ptxas": {n: chip_smoke.ptxas_kernels(str(b["ptxas"]))
                               for n, b in built.items()
                               if n.startswith("flash_")}})
    for phase in sys.argv[1:] or ("flash_fp16", "flash_kernel",
                                  "flash_varlen_kernel",
                                  "gather_gemm_kernel"):
        getattr(chip_smoke, "phase_" + phase)()
    return 0


if __name__ == "__main__":
    sys.exit(main())
