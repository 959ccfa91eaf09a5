"""Measure what a checkpoint's speed on this host rests on: the free space
and filesystem type of the working directory and ``TMPDIR``, the write
rate of four 1 GB files (synced), ``zlib.crc32`` on one core and over four
files in four threads, and a 4 GB copy on the card (device clone, to
pageable host memory, pinned allocation, to pinned host memory).

    python3 tools/ckpt_io_probe.py [--lock GB]

``--lock GB`` instead times making a host buffer of GB gigabytes
page-locked, as an async checkpoint's snapshot does, four ways (a fresh
``torch.empty`` then ``cudaHostRegister``; the same after touching every
page with the process's intra-op threads; an anonymous ``mmap`` advised
for huge pages, then registered; ``pin_memory=True``), and the copy of
as many bytes from the card into the locked buffer.

Prints one line a measurement; writes and deletes its files under
``TMPDIR``.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _fs(path):
    best = ("?", "")
    real = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            _dev, mnt, fs = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[1]):
                best = (fs, mnt)
    return best


def _crc(path):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 24)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def _lock_ways(gb: float) -> None:
    import mmap

    n = int(gb * 1e9)
    cudart = torch.cuda.cudart()
    src = torch.empty(n, dtype=torch.uint8, device="cuda")

    def register(buf, name, t0):
        err = int(cudart.cudaHostRegister(buf.data_ptr(), n, 0))
        t1 = time.perf_counter()
        buf.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        print(f"lock {gb} GB {name}: {t1 - t0:.3f} s (cudaError {err}); "
              f"copy from the card {time.perf_counter() - t1:.3f} s",
              flush=True)
        if err == 0:
            cudart.cudaHostUnregister(buf.data_ptr())

    t0 = time.perf_counter()
    register(torch.empty(n, dtype=torch.uint8), "empty+register", t0)
    t0 = time.perf_counter()
    buf = torch.empty(n, dtype=torch.uint8)
    buf.zero_()
    register(buf, f"empty+zero_({torch.get_num_threads()} threads)"
             "+register", t0)
    del buf
    t0 = time.perf_counter()
    mm = mmap.mmap(-1, n)
    if hasattr(mmap, "MADV_HUGEPAGE"):
        mm.madvise(mmap.MADV_HUGEPAGE)
    register(torch.frombuffer(mm, dtype=torch.uint8), "mmap(hugepage)"
             "+register", t0)
    t0 = time.perf_counter()
    p = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    t1 = time.perf_counter()
    p.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    print(f"lock {gb} GB pin_memory=True: {t1 - t0:.3f} s; copy from the "
          f"card {time.perf_counter() - t1:.3f} s", flush=True)


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          np.__version__)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    if "--lock" in sys.argv:
        for f in ("enabled", "defrag"):
            fp = f"/sys/kernel/mm/transparent_hugepage/{f}"
            if os.path.exists(fp):
                print("THP", f, open(fp).read().strip())
        _lock_ways(float(sys.argv[sys.argv.index("--lock") + 1]))
        return 0
    for d in (os.getcwd(), tempfile.gettempdir()):
        u = shutil.disk_usage(d)
        print("disk", d, "fs", _fs(d), "free GB", u.free / 1e9)
    d = tempfile.mkdtemp(prefix="ckpt_io_probe_")
    try:
        a = np.random.default_rng(0).integers(0, 255, 1 << 30,
                                              dtype=np.uint8)
        t0 = time.perf_counter()
        for i in range(4):
            with open(os.path.join(d, f"f{i}.bin"), "wb") as f:
                f.write(memoryview(a))
        os.sync()
        print("write 4 GB s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        zlib.crc32(memoryview(a))
        print("crc 1 GB one thread s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(_crc, [os.path.join(d, f"f{i}.bin")
                               for i in range(4)]))
        print("crc 4 files 4 threads s", time.perf_counter() - t0)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not torch.cuda.is_available():
        return 0
    x = torch.empty(1 << 32, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = x.clone()
    torch.cuda.synchronize()
    print("d2d clone 4 GB s", time.perf_counter() - t0)
    del y
    t0 = time.perf_counter()
    x.cpu()
    print("d2h pageable 4 GB s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    p = torch.empty(1 << 32, dtype=torch.uint8, pin_memory=True)
    print("pin alloc 4 GB s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    p.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    print("d2h pinned 4 GB s", time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
