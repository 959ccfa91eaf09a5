"""Time the DataLoader's copy to the card against a step that keeps the card
busy, three ways on one input:

* ``loader``: ``DataLoader(..., device="cuda")`` as it is (each batch
  page-locked and copied on the consumer's stream when it is handed over);
* ``side_prefetch``: the same batches from ``device="cpu"``, page-locked
  and copied one batch ahead on a side stream, the consumer's stream
  waiting on the copy's event and ``record_stream``-ing each tensor (the
  prefetch the loader does not do);
* ``resident``: the step alone over the batches already on the card (the
  floor: no copy at all).

The input is 64 images of 3 x 224 x 224 f32 in batches of 16 (9.6 MB, 4 a
epoch); the step is 24 f32 2048 x 2048 matmuls. Each way's number is the
median ms a step over 3 timed epochs after one warm epoch, the ways taking
turns (loader, side_prefetch, resident, resident, side_prefetch, loader).
``--workers N`` assembles the batches in N persistent worker processes
(each loader's pool starts in its warm epoch).

    python3 tools/loader_copy_probe.py [--workers N]

Prints one JSON line with the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddlepaddle_tpu_torch.io import DataLoader, TensorDataset  # noqa: E402


def _side_prefetch(loader):
    stream = torch.cuda.Stream()

    def stage(host):
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(stream):
            out = [t.to("cuda", non_blocking=True) for t in pinned]
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def take(staged):
        out, done = staged
        cur = torch.cuda.current_stream()
        cur.wait_event(done)
        for t in out:
            t.record_stream(cur)
        return out

    pending = None
    for host in loader:
        staged = stage(host)
        if pending is not None:
            yield take(pending)
        pending = staged
    if pending is not None:
        yield take(pending)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loader_copy_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    ds = TensorDataset([np.random.default_rng(1).standard_normal(
        (64, 3, 224, 224)).astype(np.float32)])
    w = torch.randn(2048, 2048, device="cuda")
    kw = dict(batch_size=16, num_workers=args.workers,
              persistent_workers=args.workers > 0)
    resident = [(b.cuda(),) for (b,) in DataLoader(ds, device="cpu", **kw)]
    ms = {k: [] for k in ("loader", "side_prefetch", "resident")}
    for way in ("loader", "side_prefetch", "resident", "resident",
                "side_prefetch", "loader"):
        # one loader a turn, so persistent workers serve its 4 epochs
        dl = DataLoader(ds, device="cuda" if way == "loader" else "cpu",
                        **kw)
        for epoch in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            batches = (dl if way == "loader" else resident
                       if way == "resident" else _side_prefetch(dl))
            for (b,) in batches:
                acc = b.mean()
                for _ in range(24):
                    acc = acc + (w @ w).mean()
                n += 1
            torch.cuda.synchronize()
            if epoch:
                ms[way].append((time.perf_counter() - t0) * 1e3 / n)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"probe": "loader_copy", "nvidia_smi": smi.strip(),
                      "workers": args.workers, "batch_mb": 16 * 3 * 224
                      * 224 * 4 / 1e6,
                      "ms_a_step": {k: statistics.median(v)
                                    for k, v in ms.items()},
                      "runs_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
