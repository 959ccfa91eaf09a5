"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library in a build
directory that ``.gitignore`` lists (``ops/kernels/_build/`` beside this
file, or ``$PADDLE_TORCH_KERNEL_BUILD_DIR``). The library's name carries a
hash of the source and the flags, so an edited source or a flag change
builds anew and a rebuilt tree never loads a stale library. Sources that
need building are compiled in parallel, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and a CPU
host has no ``nvcc``. Each ``nvcc`` run counts in :data:`nvcc_runs` and is
reported to the capture/build watchdog (``observability.watchdog``) as a
build of its source; a library already on disk (built earlier, or placed
by a serving bundle) is no build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR_ENV = "PADDLE_TORCH_KERNEL_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# per-source record of the last build in this process: seconds, whether the
# library was already on disk, and ptxas' register/shared-memory report
build_log: Dict[str, Dict[str, object]] = {}
nvcc_runs = 0    # nvcc processes this process started


def build_dir() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, object]]:
    """Build every source in ``names`` (default: all) that is not on disk
    yet, one ``nvcc`` each, all started together. Raises with the
    compiler's output when any build fails."""
    global nvcc_runs
    names = list(sources() if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            build_log[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
        nvcc_runs += 1
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        build_log[name] = {"seconds": round(time.perf_counter() - t0, 3),
                           "cached": False, "ptxas": log}
        from ...observability import watchdog

        watchdog.record_compile("build", name, build_log[name]["seconds"])
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: build_log[n] for n in names}


def check_device(device) -> None:
    """The kernels are built for ``sm_90a`` only: raise on any other card."""
    import torch

    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
